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
//   8.   loss                    pr[b,c] = ‖A0x' − z'‖, dr[b,c] = ‖Qx' + p + A0ᵀy'‖
//                                at the step's loss column c (c = k here)
//
// Two compute dtypes (the entry point's f32 flag), as the TPU kernel's
// compute_dtype: bf16 (Q, A0, W, U, W_h in bf16, every vector rounded to
// bf16 before a matvec, the wgmma gate GEMM of cell_gemm.cuh) or float32
// (all of them float32, nothing rounded, the gate GEMM on the CUDA cores in
// FFMA; the TPU kernel runs these products at Precision.HIGHEST).
//
// The streams are the carries.  They are step-major, slot k·B + b, rather
// than the TPU kernel's b·(J+1) + k, so that a step's slab is contiguous and
// the kernels address it as rollout.cu addresses its carries:
//   hs (J+1, B·S, h) cdt    H as the gate GEMM consumes it: the GEMM reads
//                           slot k and its epilogue writes H' (bf16(H') in
//                           the bf16 profile) to k+1
//   cs (J+1, B·S, h) f32    C: read from slot k, C' written to k+1
//   xs, ys, zs, xvs (J+1, B, ·) f32
// Slot 0 holds the chunk's start state (the wrapper copies it in), slot J the
// final one.  H is carried in float32 on the TPU and rounded to bf16 where it
// is consumed; the gate GEMM rounds it when the epilogue stores slot k+1, so
// the values are the same.  The final H' is also written unrounded in
// float32 to H_final on the last step.
//
// Bound on the H100 at B=2, S=2000, h=800, J=100: the gate GEMM,
// J·2·B·S·h·4h = 2.05 TFLOP, 2.07 ms at 989 TFLOP/s (bf16) or 30.6 ms at 67
// TFLOP/s (float32), against 1.92 GB (bf16 H) or 2.56 GB (float32 H) of
// stream writes (0.57 / 0.76 ms at 3.35 TB/s): operations.
//
// iadmm_train_fwd_seg replaces _fwd_seg_kernel, the forward of the segment
// route (make_fused_chunk_loss with stream=False, seg > 0, or streams over
// IADMM_STREAM_HBM): the same steps over carries of two slots instead of
// J+1, one call per segment of J steps, no stream written.  The wrapper
// keeps each segment's start state (H and C in float32) as the checkpoint
// that train_bwd.cu's segment entry point recomputes from.  Its bound is
// the same GEMM operations as the stream forward's.

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
                            int col, int L, int n, int m) {
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
    pr[b * L + col] = sqrtf(s1);
    dr[b * L + col] = sqrtf(s2);
  }
}

// Schedule index t from slot src of the carries to slot dst, the losses at
// column col of the (B, L) pr, dr, with T data and weights (see the entry
// points).
template <typename T>
void step(const admm::Problem& P, const admm::Weights& w,
          const admm::KktScratch& ks, int t, int src, int dst, int col, int L,
          void* hs, void* cs, void* xs, void* ys, void* zs, void* xvs,
          void* H_final, void* pr, void* dr, void* r, void* g,
          void* cell_partial, cudaStream_t s) {
  const int B = P.B, n = P.n, m = P.m;
  const int M = B * (n + m);
  const size_t slab = (size_t)M * w.h;
  float* xv_k = static_cast<float*>(xvs) + (size_t)src * M;
  float* x_k = static_cast<float*>(xs) + (size_t)src * B * n;
  float* y_k = static_cast<float*>(ys) + (size_t)src * B * m;
  float* z_k = static_cast<float*>(zs) + (size_t)src * B * m;
  float* xv_n = static_cast<float*>(xvs) + (size_t)dst * M;
  float* x_n = static_cast<float*>(xs) + (size_t)dst * B * n;
  float* y_n = static_cast<float*>(ys) + (size_t)dst * B * m;
  float* z_n = static_cast<float*>(zs) + (size_t)dst * B * m;

  admm::iteration<T>(P, w, t, xv_k, x_k, y_k, z_k,
                     static_cast<const T*>(hs) + src * slab,
                     static_cast<const float*>(cs) + src * slab, xv_n, x_n,
                     y_n, z_n, static_cast<T*>(hs) + dst * slab,
                     static_cast<float*>(cs) + dst * slab,
                     static_cast<float*>(H_final), static_cast<float*>(r),
                     static_cast<float*>(g),
                     static_cast<float*>(cell_partial), ks, s);
  kkt::colpass<T, admm::kRound<T>>(P.Q, P.A0, x_n, n, y_n, m, ks.partial,
                                   ks.rowdot, n, m, B, s);
  loss_kernel<<<B, 256, 0, s>>>(ks.partial, ks.rowdot, kkt::n_chunks(n, m),
                                P.p, z_n, static_cast<float*>(pr),
                                static_cast<float*>(dr), col, L, n, m);
}

// Steps i = 0 … nsteps−1 (schedule index t0 + i, losses at column col + i):
// from slot k0 + i to k0 + i + 1 of the streams, or, with two_slots, from
// slot i mod 2 to the other one; the last step's H' also goes to H_final
// when it is not null.
int run_steps(int t0, int k0, int nsteps, bool two_slots, int col, int L,
              const void* Q, const void* A0, const void* p, const void* zl,
              const void* zu, const void* rhom, const void* rho_raw,
              const void* alpha_raw, const void* W, const void* Ut,
              const void* b, const void* Wh, const void* bh, void* hs,
              void* cs, void* xs, void* ys, void* zs, void* xvs,
              void* H_final, void* pr, void* dr, void* r, void* g,
              void* mv_partial, void* rowdot, void* cell_partial, int B,
              int n, int m, int h, int f32, float sigma, void* stream) {
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
  const admm::Weights w{W, Ut, static_cast<const float*>(b), Wh,
                        static_cast<const float*>(bh), h};
  const admm::KktScratch ks{static_cast<float*>(mv_partial),
                            static_cast<float*>(rowdot)};
  auto run = f32 ? &step<float> : &step<__nv_bfloat16>;
  for (int i = 0; i < nsteps; ++i) {
    const int src = two_slots ? (i & 1) : k0 + i;
    const int dst = two_slots ? ((i + 1) & 1) : k0 + i + 1;
    run(P, w, ks, t0 + i, src, dst, col + i, L, hs, cs, xs, ys, zs, xvs,
        i == nsteps - 1 ? H_final : nullptr, pr, dr, r, g, cell_partial,
        static_cast<cudaStream_t>(stream));
  }
  return hop::last_error();
}

}  // namespace

extern "C" {

// Step k of the chunk (schedule index t).  Q (B,n,n), A0 (B,m,n), W (2,4h),
// Wh (h,) bf16, and Ut, U (h,4h) re-laid for the bf16 cell GEMM
// (cell_gemm.cuh); or all float32 when f32, Ut then U itself; p (B,n), zl,
// zu, rhom (B,m), rho_raw/alpha_raw (K_total,), b (4h,), bh (1,) float32.
// Streams as in the header (hs in the dtype of Q); slot k is read and slot
// k+1 written.  H_final (B·S, h) float32 or null.  pr, dr (B, J) float32:
// column k written.  r, g (B,n+m), mv_partial (B, ceil((n+m)/32), n),
// rowdot (B,m), cell_partial (cell::n_partials(h), B·(n+m)) are scratch.
int iadmm_train_fwd_step(int k, int t, const void* Q, const void* A0,
                         const void* p, const void* zl, const void* zu,
                         const void* rhom, const void* rho_raw,
                         const void* alpha_raw, const void* W, const void* Ut,
                         const void* b, const void* Wh, const void* bh,
                         void* hs, void* cs, void* xs, void* ys, void* zs,
                         void* xvs, void* H_final, void* pr, void* dr,
                         void* r, void* g, void* mv_partial, void* rowdot,
                         void* cell_partial, int B, int n, int m, int h,
                         int J, int f32, float sigma, void* stream) {
  return run_steps(t, k, 1, false, k, J, Q, A0, p, zl, zu, rhom, rho_raw,
                   alpha_raw, W, Ut, b, Wh, bh, hs, cs, xs, ys, zs, xvs,
                   H_final, pr, dr, r, g, mv_partial, rowdot, cell_partial, B,
                   n, m, h, f32, sigma, stream);
}

// Replaces _fwd_seg_kernel (train_rollout.py:147): one segment of J steps,
// schedule indices t0 … t0+J−1, from a checkpoint, keeping no stream.  The
// carries have two slots, hs (2, B·S, h) in the dtype of Q, cs (2, B·S, h),
// xs (2,B,n), ys, zs (2,B,m), xvs (2,B,S) float32, the checkpoint in slot 0
// (the wrapper copies it in); step k reads slot k mod 2 and writes the
// other, so the final state is in slot J mod 2 and its H', unrounded, in
// H_final (B·S, h) float32, as the TPU kernel writes out its float32 H
// carry.  Step k's losses land at column col + k of pr, dr (B, L), the
// chunk's, apart from the slot index.  The rest as in iadmm_train_fwd_step.
// The launches are those of J calls of the stream entry point, so on the
// same start state both routes give bitwise-equal states and losses.
int iadmm_train_fwd_seg(int t0, int col, int L, const void* Q, const void* A0,
                        const void* p, const void* zl, const void* zu,
                        const void* rhom, const void* rho_raw,
                        const void* alpha_raw, const void* W, const void* Ut,
                        const void* b, const void* Wh, const void* bh,
                        void* hs, void* cs, void* xs, void* ys, void* zs,
                        void* xvs, void* H_final, void* pr, void* dr, void* r,
                        void* g, void* mv_partial, void* rowdot,
                        void* cell_partial, int B, int n, int m, int h, int J,
                        int f32, float sigma, void* stream) {
  return run_steps(t0, 0, J, true, col, L, Q, A0, p, zl, zu, rhom, rho_raw,
                   alpha_raw, W, Ut, b, Wh, bh, hs, cs, xs, ys, zs, xvs,
                   H_final, pr, dr, r, g, mv_partial, rowdot, cell_partial, B,
                   n, m, h, f32, sigma, stream);
}

}  // extern "C"
