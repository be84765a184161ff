// One learned ADMM iteration of the serving rollout, for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/rollout_kernel.py::_rollout_kernel (driven
// there by fused_rollout).  The TPU kernel runs all K iterations of one
// instance per grid step with Q, A0 and the state resident in VMEM; 2 MB of
// Q and 1 MB of A0 per instance (bf16, n = m = 1000) do not fit in the
// 227 KB of shared memory of an SM, and a grid of B CTAs would use 8 of 132
// SMs.  Here the host loops over K and each iteration is six launches that
// spread every instance over many CTAs:
//   1. colpass(xv)        Q·u + A0ᵀ·ν partials and A0·u   (kkt_matvec.cuh)
//   2. finish(pass 1)     r = Ã·xv − b̃
//   3. colpass(r)
//   4. finish(pass 2)     g = Ã·r
//   5. cell GEMM          gates, C (in place), H' (ping-pong), delta
//                         partials                         (cell_gemm.cuh)
//   6. update             delta = Σ partials + b_h, xv ← xv − delta, then
//                         the x/z/y update
// The matrices stay in L2 between passes (24 MB of bf16 data at B = 8).
//
// Bound on the H100: the gate GEMM, 2·B·(n+m)·h·4h operations a step
// (82 GFLOP at B = 8, h = 800: 83 µs at 989 TFLOP/s); the KKT passes read
// 4 x 3 MB of bf16 data per instance and step, which the L2 serves.
//
// Numerics follow the TPU kernel: every vector is rounded to bf16 before
// each matvec (rollout_kernel.py:78-91); the x·W term is float32 xv and g
// against bf16 W (:124); H is carried in bf16 and C in float32 (:251-252);
// ρ_row = σ(ρ_t)·(1e3 on equality rows), α = 2σ(α_t),
// z = min(max(z_t + y/ρ, zl), zu) with z-relaxation off (:145-154).

#include "cell_gemm.cuh"
#include "kkt_matvec.cuh"

namespace {

using namespace iadmm;

// pass 1: out = Ã·xv − b̃ ; pass 2: out = Ã·r.  v is the vector the matvec
// pass consumed, (B, n+m).
__global__ void finish_kernel(int pass, const float* __restrict__ partial,
                              const float* __restrict__ rowdot, int nchunks,
                              const float* __restrict__ v,
                              const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ z,
                              const float* __restrict__ p,
                              const float* __restrict__ rho_raw,
                              const float* __restrict__ rhom, int t,
                              float sigma, float* __restrict__ out, int n,
                              int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    float top = kkt::sum_partials(partial, b, nchunks, n, s) + sigma * v[idx];
    if (pass == 1) top -= sigma * x[b * n + s] - p[b * n + s];
    out[idx] = top;
  } else {
    const int k = b * m + (s - n);
    const float rho = sigmoidf(rho_raw[t]) * rhom[k];
    float bot = rowdot[k] - v[idx] / rho;
    if (pass == 1) bot -= z[k] - y[k] / rho;
    out[idx] = bot;
  }
}

__global__ void update_kernel(const float* __restrict__ partial, int ntiles,
                              const float* __restrict__ bh,
                              float* __restrict__ xv, float* __restrict__ x,
                              float* __restrict__ y, float* __restrict__ z,
                              const float* __restrict__ zl,
                              const float* __restrict__ zu,
                              const float* __restrict__ rho_raw,
                              const float* __restrict__ alpha_raw,
                              const float* __restrict__ rhom, int t, int n,
                              int m, int B) {
  const int S = n + m, M = B * S;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M) return;
  const int b = idx / S, s = idx % S;
  float d = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) d += partial[(size_t)tile * M + idx];
  const float xvn = xv[idx] - (d + bh[0]);
  xv[idx] = xvn;
  if (s < n) {
    const float alpha = 2.0f * sigmoidf(alpha_raw[t]);
    const int k = b * n + s;
    x[k] = alpha * xvn + (1.0f - alpha) * x[k];
  } else {
    const int k = b * m + (s - n);
    const float rho = sigmoidf(rho_raw[t]) * rhom[k];
    const float yk = y[k];
    const float zt = z[k] + (xvn - yk) / rho;
    const float zn = fminf(fmaxf(zt + yk / rho, zl[k]), zu[k]);
    y[k] = yk + rho * (zt - zn);
    z[k] = zn;
  }
}

}  // namespace

extern "C" {

// Learned iteration t.  Q (B,n,n), A0 (B,m,n), W (2,4h), U (h,4h), Wh (h,)
// in bf16; everything else float32.  rho_raw/alpha_raw: the raw (K,)
// schedules; rhom (B,m): 1e3 on equality rows, else 1.  xv (B,n+m), x, y, z
// are updated in place, C (B·(n+m), h) in place; H_in is read and H_out
// written (the caller swaps them).  r, g (B,n+m), mv_partial
// (B, ceil((n+m)/32), n), rowdot (B,m), cell_partial (ceil(h/16), B·(n+m))
// are scratch.
int iadmm_rollout_step(int t, const void* Q, const void* A0, const void* p,
                       const void* zl, const void* zu, const void* rhom,
                       const void* rho_raw, const void* alpha_raw,
                       const void* W, const void* U, const void* b,
                       const void* Wh, const void* bh, void* xv, void* x,
                       void* y, void* z, void* r, void* g, void* H_in,
                       void* H_out, void* C, void* mv_partial, void* rowdot,
                       void* cell_partial, int B, int n, int m, int h,
                       float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n + m, M = B * S;
  const int nch = kkt::n_chunks(n, m);
  const int eblocks = (M + 255) / 256;
  float* xvf = static_cast<float*>(xv);
  float* rf = static_cast<float*>(r);
  float* gf = static_cast<float*>(g);
  float* part = static_cast<float*>(mv_partial);
  float* rd = static_cast<float*>(rowdot);
  const float* pf = static_cast<const float*>(p);
  const float* rr = static_cast<const float*>(rho_raw);
  const float* rm = static_cast<const float*>(rhom);

  kkt::colpass<__nv_bfloat16, true>(Q, A0, xvf, S, xvf + n, S, part, rd, n, m,
                                    B, s);
  finish_kernel<<<eblocks, 256, 0, s>>>(
      1, part, rd, nch, xvf, static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(z), pf, rr, rm,
      t, sigma, rf, n, m, B);
  kkt::colpass<__nv_bfloat16, true>(Q, A0, rf, S, rf + n, S, part, rd, n, m,
                                    B, s);
  finish_kernel<<<eblocks, 256, 0, s>>>(2, part, rd, nch, rf, nullptr,
                                        nullptr, nullptr, nullptr, rr, rm, t,
                                        sigma, gf, n, m, B);
  cell::launch<__nv_bfloat16, float>(xvf, gf, 1, 0, H_in, C, W, U,
                                     static_cast<const float*>(b), Wh, H_out,
                                     C, static_cast<float*>(cell_partial), M,
                                     h, s);
  update_kernel<<<eblocks, 256, 0, s>>>(
      static_cast<const float*>(cell_partial), cell::n_tiles(h),
      static_cast<const float*>(bh), xvf, static_cast<float*>(x),
      static_cast<float*>(y), static_cast<float*>(z),
      static_cast<const float*>(zl), static_cast<const float*>(zu), rr,
      static_cast<const float*>(alpha_raw), rm, t, n, m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
