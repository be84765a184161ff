// One learned ADMM iteration of a TBPTT training chunk, forward, for Hopper
// (sm_90a), with the per-step losses and the state streams the backward
// reads.
//
// Replaces iadmm_tpu/kernels/train_rollout.py::_fwd_stream_kernel (built by
// make_fused_chunk_loss(stream=True)).  The TPU kernel runs the J steps of
// one instance per grid step with Q, A0 and the recurrent state in VMEM and
// DMAs every pre-step state to HBM.  As in rollout.cu, the host loops here:
// one call per step k of the chunk (schedule index t = t0 + k), launching
//   1-6. admm::iteration         the rollout's six launches, from slot k to
//                                slot k+1 (admm_step.cuh): r = Ã·xv − b̃,
//                                g = Ã·r, the cell GEMM (gates, C', H',
//                                delta partials), the xv, x, y, z update
//   7.   colpass(x', y')         A0·x', Q·x' + A0ᵀ·y'
//   8.   loss                    pr[b,k] = ‖A0x' − z'‖, dr[b,k] = ‖Qx' + p + A0ᵀy'‖
//
// The streams are the carries.  They are step-major, slot k·B + b, rather
// than the TPU kernel's b·(J+1) + k, so that a step's slab is contiguous and
// the kernels address it as rollout.cu addresses its carries:
//   hs (J+1, B·S, h) bf16   H as the gate GEMM consumes it: the GEMM reads
//                           slot k and its epilogue writes bf16(H') to k+1
//   cs (J+1, B·S, h) f32    C: read from slot k, C' written to k+1
//   xs, ys, zs, xvs (J+1, B, ·) f32
// Slot 0 holds the chunk's start state (the wrapper copies it in), slot J the
// final one.  H is carried in float32 on the TPU and rounded to bf16 where it
// is consumed; the gate GEMM rounds it when the epilogue stores slot k+1, so
// the values are the same.  The final H' is also written unrounded in
// float32 to H_final on the last step.
//
// Bound on the H100 at B=2, S=2000, h=800, J=100: the gate GEMM,
// J·2·B·S·h·4h = 2.05 TFLOP, 2.07 ms at 989 TFLOP/s, against 1.92 GB of
// stream writes (0.57 ms at 3.35 TB/s): operations.

#include "admm_step.cuh"

namespace {

using namespace iadmm;

// One CTA per instance: v1 = A0·x' − z', v2 = Q·x' + A0ᵀ·y' + p from the
// colpass over (x', y'), then the two norms in a fixed order.
__global__ void loss_kernel(const float* __restrict__ partial,
                            const float* __restrict__ rowdot, int nchunks,
                            const float* __restrict__ p,
                            const float* __restrict__ z_new,
                            float* __restrict__ pr, float* __restrict__ dr,
                            int k, int J, int n, int m) {
  __shared__ float scratch[33];
  const int b = blockIdx.x;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float v1 = rowdot[b * m + i] - z_new[b * m + i];
    s1 += v1 * v1;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v2 = kkt::sum_partials(partial, b, nchunks, n, j) + p[b * n + j];
    s2 += v2 * v2;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    pr[b * J + k] = sqrtf(s1);
    dr[b * J + k] = sqrtf(s2);
  }
}

}  // namespace

extern "C" {

// Step k of the chunk (schedule index t).  Q (B,n,n), A0 (B,m,n), W (2,4h),
// U (h,4h), Wh (h,) bf16; p (B,n), zl, zu, rhom (B,m), rho_raw/alpha_raw
// (K_total,), b (4h,), bh (1,) float32.  Streams as in the header; slot k is
// read and slot k+1 written.  H_final (B·S, h) float32 or null.  pr, dr
// (B, J) float32: column k written.  r, g (B,n+m), mv_partial
// (B, ceil((n+m)/32), n), rowdot (B,m), cell_partial (ceil(h/16), B·(n+m))
// are scratch.
int iadmm_train_fwd_step(int k, int t, const void* Q, const void* A0,
                         const void* p, const void* zl, const void* zu,
                         const void* rhom, const void* rho_raw,
                         const void* alpha_raw, const void* W, const void* U,
                         const void* b, const void* Wh, const void* bh,
                         void* hs, void* cs, void* xs, void* ys, void* zs,
                         void* xvs, void* H_final, void* pr, void* dr,
                         void* r, void* g, void* mv_partial, void* rowdot,
                         void* cell_partial, int B, int n, int m, int h,
                         int J, float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * (n + m);
  const size_t slab = (size_t)M * h;
  const admm::Problem P{Q,
                        A0,
                        static_cast<const float*>(p),
                        static_cast<const float*>(zl),
                        static_cast<const float*>(zu),
                        static_cast<const float*>(rhom),
                        static_cast<const float*>(rho_raw),
                        static_cast<const float*>(alpha_raw),
                        B,
                        n,
                        m,
                        sigma};
  const admm::Weights w{W, U, static_cast<const float*>(b), Wh,
                        static_cast<const float*>(bh), h};
  const admm::KktScratch ks{static_cast<float*>(mv_partial),
                            static_cast<float*>(rowdot)};
  float* xv_k = static_cast<float*>(xvs) + (size_t)k * M;
  float* x_k = static_cast<float*>(xs) + (size_t)k * B * n;
  float* y_k = static_cast<float*>(ys) + (size_t)k * B * m;
  float* z_k = static_cast<float*>(zs) + (size_t)k * B * m;
  float* x_n = x_k + B * n;
  float* y_n = y_k + B * m;
  float* z_n = z_k + B * m;

  admm::iteration(P, w, t, xv_k, x_k, y_k, z_k,
                  static_cast<const __nv_bfloat16*>(hs) + k * slab,
                  static_cast<const float*>(cs) + k * slab, xv_k + M, x_n,
                  y_n, z_n, static_cast<__nv_bfloat16*>(hs) + (k + 1) * slab,
                  static_cast<float*>(cs) + (k + 1) * slab,
                  static_cast<float*>(H_final), static_cast<float*>(r),
                  static_cast<float*>(g), static_cast<float*>(cell_partial),
                  ks, s);
  kkt::colpass<__nv_bfloat16, true>(Q, A0, x_n, n, y_n, m, ks.partial,
                                    ks.rowdot, n, m, B, s);
  loss_kernel<<<B, 256, 0, s>>>(ks.partial, ks.rowdot, kkt::n_chunks(n, m),
                                P.p, z_n, static_cast<float*>(pr),
                                static_cast<float*>(dr), k, J, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
