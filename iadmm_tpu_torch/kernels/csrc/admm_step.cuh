// One learned ADMM iteration, shared by rollout.cu (serving) and
// train_fwd.cu / train_bwd.cu (training).
//
// finish_kernel turns a KKT colpass (kkt_matvec.cuh) into the blocks of
//   pass 1: r = Ã·xv − b̃        pass 2: out = Ã·v
// with Ã = [[Q + σI, A0ᵀ], [A0, −diag(1/ρ)]] and b̃ = [σx − p; z − y/ρ].
// update_kernel sums the cell's delta partials in a fixed order, takes
// xv ← xv − delta and applies the x/z/y update with z-relaxation off.
// The numerics are those of the TPU kernels (rollout_kernel.py:145-154,
// train_rollout.py:193-212): ρ_row = σ(ρ_t)·(1e3 on equality rows),
// α = 2σ(α_t), z = min(max(z_t + y/ρ, zl), zu).
//
// The host functions at the end launch these in the iteration's order:
// kkt_apply (out = Ã·v), features (r and g), iteration (features, the cell
// GEMM of cell_gemm.cuh, the update).  The training forward also hands
// features a Loss: its first pass then carries the previous step's loss
// vectors (x, y) as a second right-hand side, and finish_kernel writes
// their loss vectors beside r.  They are templates on T, the type of
// the problem data and the cell weights: bf16 (the fast profile: every
// vector rounded to bf16 before a matvec, the wgmma cell GEMM, bf16 H) or
// float (the float32 profile: nothing rounded, FFMA cell GEMM, float32 H).
#pragma once

#include <type_traits>

#include "cell_gemm.cuh"
#include "kkt_matvec.cuh"

namespace iadmm {
namespace admm {

// Element s of instance b of the loss vectors of the state (x, y, z) from
// the pass over (x, y): v2 = Q·x + A0ᵀ·y + p (s < n), v1 = A0·x − z.
__device__ __forceinline__ float loss_vec(const float* partial,
                                          const float* rowdot, int nchunks,
                                          const float* p, const float* z,
                                          int b, int s, int n, int m) {
  if (s < n) return kkt::sum_partials(partial, b, nchunks, n, s) + p[b * n + s];
  return rowdot[b * m + (s - n)] - z[b * m + (s - n)];
}

// v: the vector the colpass consumed, (B, n+m).  x, y, z, p are read in
// pass 1 only.  lv, when not null (pass 1): the loss vectors of (x, y, z)
// from lpart / lrow, the pass's second right-hand side, (B, n+m).
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
                              int m, int B,
                              const float* __restrict__ lpart,
                              const float* __restrict__ lrow,
                              float* __restrict__ lv) {
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
  if (lv) lv[idx] = loss_vec(lpart, lrow, nchunks, p, z, b, s, n, m);
}

// Reads xv, x, y, z of the iteration's start from the *_in pointers and
// writes the new ones to *_out; the rollout passes the same pointers for
// both (in place: each thread reads its element before it writes it).
__global__ void update_kernel(const float* __restrict__ partial, int nparts,
                              const float* __restrict__ bh,
                              const float* xv_in, float* xv_out,
                              const float* x_in, float* x_out,
                              const float* y_in, float* y_out,
                              const float* z_in, float* z_out,
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
  for (int t = 0; t < nparts; ++t) d += partial[(size_t)t * M + idx];
  const float xvn = xv_in[idx] - (d + bh[0]);
  xv_out[idx] = xvn;
  if (s < n) {
    const float alpha = 2.0f * sigmoidf(alpha_raw[t]);
    const int k = b * n + s;
    x_out[k] = alpha * xvn + (1.0f - alpha) * x_in[k];
  } else {
    const int k = b * m + (s - n);
    const float rho = sigmoidf(rho_raw[t]) * rhom[k];
    const float yk = y_in[k];
    const float zt = z_in[k] + (xvn - yk) / rho;
    const float zn = fminf(fmaxf(zt + yk / rho, zl[k]), zu[k]);
    y_out[k] = yk + rho * (zt - zn);
    z_out[k] = zn;
  }
}

inline int eblocks(int count) { return (count + 255) / 256; }

// A matvec against T data rounds its vector to T first (bf16) or not.
template <typename T>
constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;

// The batch's data and schedules: Q (B,n,n), A0 (B,m,n) in T; p (B,n),
// zl, zu, rhom (B,m), rho_raw, alpha_raw (K,) float32.
struct Problem {
  const void* Q;
  const void* A0;
  const float* p;
  const float* zl;
  const float* zu;
  const float* rhom;
  const float* rho_raw;
  const float* alpha_raw;
  int B, n, m;
  float sigma;
};

// The cell's weights: W (2,4h), Wh (h,) in T; b (4h,), bh (1,) float32;
// Ut in T: U (h,4h) re-laid for the bf16 cell GEMM (cell_gemm.cuh), U
// itself for float32 weights.
struct Weights {
  const void* W;
  const void* Ut;
  const float* b;
  const void* Wh;
  const float* bh;
  int h;
};

// Scratch of the colpass: partial (B, ceil((n+m)/32), n), rowdot (B,m).
struct KktScratch {
  float* partial;
  float* rowdot;
};

// The pending loss that an iteration's first pass carries: the pass over
// the iteration's own (x, y) into ks, the loss vectors into lv (B, n+m).
struct Loss {
  KktScratch ks;
  float* lv;
};

// out = Ã·v at schedule index t; v, out (B, n+m).
template <typename T>
inline void kkt_apply(const Problem& P, int t, const float* v, float* out,
                      const KktScratch& ks, cudaStream_t s) {
  const int S = P.n + P.m;
  kkt::colpass<T, kRound<T>>(P.Q, P.A0, v, S, v + P.n, S, ks.partial,
                             ks.rowdot, P.n, P.m, P.B, s);
  finish_kernel<<<eblocks(P.B * S), 256, 0, s>>>(
      2, ks.partial, ks.rowdot, kkt::n_chunks(P.n, P.m), v, nullptr, nullptr,
      nullptr, nullptr, P.rho_raw, P.rhom, t, P.sigma, out, P.n, P.m, P.B,
      nullptr, nullptr, nullptr);
}

// The KKT features of iteration t at the state (xv, x, y, z):
// r = Ã·xv − b̃ and g = Ã·r, each (B, n+m).  With a loss, the first pass
// also reads [Q; A0] against (x, y) and the loss vectors of the state go
// to loss->lv.
template <typename T>
inline void features(const Problem& P, int t, const float* xv,
                     const float* x, const float* y, const float* z, float* r,
                     float* g, const KktScratch& ks, cudaStream_t s,
                     const Loss* loss = nullptr) {
  const int S = P.n + P.m;
  const kkt::Rhs first{xv, S, xv + P.n, S, ks.partial, ks.rowdot};
  if (loss)
    kkt::colpass2<T, kRound<T>>(
        P.Q, P.A0, first,
        kkt::Rhs{x, P.n, y, P.m, loss->ks.partial, loss->ks.rowdot}, P.n,
        P.m, P.B, s);
  else
    kkt::colpass<T, kRound<T>>(P.Q, P.A0, xv, S, xv + P.n, S, ks.partial,
                               ks.rowdot, P.n, P.m, P.B, s);
  finish_kernel<<<eblocks(P.B * S), 256, 0, s>>>(
      1, ks.partial, ks.rowdot, kkt::n_chunks(P.n, P.m), xv, x, y, z, P.p,
      P.rho_raw, P.rhom, t, P.sigma, r, P.n, P.m, P.B,
      loss ? loss->ks.partial : nullptr, loss ? loss->ks.rowdot : nullptr,
      loss ? loss->lv : nullptr);
  kkt_apply<T>(P, t, r, g, ks, s);
}

// Learned iteration t from the state (xv, x, y, z, H, C) to the *_out one:
// features, the cell GEMM (H in T, float32 C; H_f32, when not null, also
// receives H' unrounded), the update.  The in and out vectors, and C and
// C_out, may be the same (in place); H_out must not alias H.  r, g
// (B, n+m), cell_partial (cell::n_partials(h), B·(n+m)) are scratch.  loss:
// as features.  ROLLOUT (bf16 only, the serving rollout): the cell runs on
// the rollout's wide tile (cell::launch_rollout; w.Ut re-laid for
// HB_ROLLOUT, H and H_out with rows of cell::ut_ld(h)), else on the
// 128 x 128 tile the training pair's sums are defined by.
template <typename T, bool ROLLOUT = false>
inline void iteration(const Problem& P, const Weights& w, int t,
                      const float* xv, const float* x, const float* y,
                      const float* z, const void* H, const void* C,
                      float* xv_out, float* x_out, float* y_out,
                      float* z_out, void* H_out, void* C_out, float* H_f32,
                      float* r, float* g, float* cell_partial,
                      const KktScratch& ks, cudaStream_t s,
                      const Loss* loss = nullptr) {
  const int M = P.B * (P.n + P.m);
  features<T>(P, t, xv, x, y, z, r, g, ks, s, loss);
  if constexpr (ROLLOUT) {
    static_assert(std::is_same<T, __nv_bfloat16>::value,
                  "the rollout's tile is a bf16 tile");
    cell::launch_rollout(xv, g, H, cell::ut_ld(w.h), C, w.W, w.Ut, w.b,
                         w.Wh, H_out, C_out, cell_partial, M, w.h, s);
  } else {
    cell::launch<T, T, float>(xv, g, 1, 0, H, C, w.W, w.Ut, w.b, w.Wh,
                              H_out, C_out, cell_partial, M, w.h, s, H_f32);
  }
  update_kernel<<<eblocks(M), 256, 0, s>>>(
      cell_partial, cell::n_partials(w.h), w.bh, xv, xv_out, x, x_out, y, y_out,
      z, z_out, P.zl, P.zu, P.rho_raw, P.alpha_raw, P.rhom, t, P.n, P.m,
      P.B);
}

}  // namespace admm
}  // namespace iadmm
