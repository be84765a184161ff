// The learned ADMM iterations of the serving rollout, for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/rollout_kernel.py::_rollout_kernel (driven
// there by fused_rollout).  The TPU kernel runs all K iterations of one
// instance per grid step with Q, A0 and the state resident in VMEM; 2 MB of
// Q and 2 MB of A0 per instance (bf16, n = m = 1000) do not fit in the
// 227 KB of shared memory of an SM, and a grid of B CTAs would use 8 of 132
// SMs.  Here each iteration is six launches that spread every instance
// over many CTAs (admm::iteration, admm_step.cuh), and one call
// (iadmm_rollout below) issues all K iterations' launches from C:
//   1. colpass(xv)        Q·u + A0ᵀ·ν partials and A0·u   (kkt_matvec.cuh)
//   2. finish(pass 1)     r = Ã·xv − b̃                   (admm_step.cuh)
//   3. colpass(r)
//   4. finish(pass 2)     g = Ã·r
//   5. cell GEMM          gates, C (in place), H' (ping-pong), delta
//                         partials (cell_gemm.cuh: the rollout's wide
//                         persistent tile, wgmma fed by a TMA ring)
//   6. update             delta = Σ partials + b_h, xv ← xv − delta, then
//                         the x/z/y update
// The matrices stay in L2 between passes (32 MB of bf16 data at B = 8).
//
// Bound on the H100: the gate GEMM, 2·B·(n+m)·h·4h operations a step
// (82 GFLOP at B = 8, h = 800: 83 µs at 989 TFLOP/s); the two KKT passes
// read 2 x 4 MB of bf16 data per instance and step (kkt_matvec.cuh), which
// the L2 serves.  U is re-laid for the rollout's cell tile (Ut, HB_ROLLOUT
// units a tile) once per rollout, by the wrapper.
//
// Numerics follow the TPU kernel: every vector is rounded to bf16 before
// each matvec (rollout_kernel.py:78-91); the x·W term is float32 xv and g
// against bf16 W (:124); H is carried in bf16 and C in float32 (:251-252);
// ρ_row = σ(ρ_t)·(1e3 on equality rows), α = 2σ(α_t),
// z = min(max(z_t + y/ρ, zl), zu) with z-relaxation off (:145-154).

#include "admm_step.cuh"

using namespace iadmm;

extern "C" {

// The K learned iterations from the state in xv, x, y, z, H_a, C, launched
// on stream.  Q (B,n,n), A0 (B,m,n), W (2,4h), Wh (h,) and Ut (U (h,4h)
// re-laid for HB_ROLLOUT, cell_gemm.cuh) in bf16; everything else float32.
// rho_raw/alpha_raw: the raw (K,) schedules; rhom (B,m): 1e3 on equality
// rows, else 1.  xv (B,n+m), x, y, z are updated in place, C (B·(n+m), h)
// in place; H_a and H_b (B·(n+m), cell::ut_ld(h)), bf16, take turns as an
// iteration's H and H'.  r, g (B,n+m), mv_partial (B, ceil((n+m)/32), n),
// rowdot (B,m), cell_partial (cell::n_partials(h), B·(n+m)) are scratch.
int iadmm_rollout(int K, const void* Q, const void* A0, const void* p,
                  const void* zl, const void* zu, const void* rhom,
                  const void* rho_raw, const void* alpha_raw, const void* W,
                  const void* Ut, const void* b, const void* Wh,
                  const void* bh, void* xv, void* x, void* y, void* z,
                  void* r, void* g, void* H_a, void* H_b, void* C,
                  void* mv_partial, void* rowdot, void* cell_partial, int B,
                  int n, int m, int h, float sigma, void* stream) {
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
  float* xvf = static_cast<float*>(xv);
  float* xf = static_cast<float*>(x);
  float* yf = static_cast<float*>(y);
  float* zf = static_cast<float*>(z);
  for (int t = 0; t < K; ++t) {
    void* H_in = t % 2 ? H_b : H_a;
    void* H_out = t % 2 ? H_a : H_b;
    admm::iteration<__nv_bfloat16, true>(
        P, w, t, xvf, xf, yf, zf, H_in, C, xvf, xf, yf, zf, H_out, C,
        nullptr, static_cast<float*>(r), static_cast<float*>(g),
        static_cast<float*>(cell_partial), ks,
        static_cast<cudaStream_t>(stream));
    if (hop::host_error() != cudaSuccess) break;  // a launch was refused
  }
  return hop::last_error();
}

}  // extern "C"
