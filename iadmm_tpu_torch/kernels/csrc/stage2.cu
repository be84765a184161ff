// One Stage-II exact polish step for Hopper (sm_90a): the solvers 'kkt',
// 'direct' and 'cg'.
//
// Replaces iadmm_tpu/kernels/stage2_kernel.py::_stage2_kernel (driven there
// by fused_stage2).  The TPU kernel runs the N polish steps of one instance
// per grid step with Q, A0 and the solver's operand resident in VMEM.  At
// n = m = 1000 one instance's Q and A0 are 8 MB in float32 and Ã⁻¹ alone is
// 16 MB, far beyond an SM's shared memory (and, over B = 8 instances, beyond
// the 50 MB L2), so here the host loops over N and each step is a sequence
// of launches that spread an instance over many CTAs.  All arithmetic is
// float32 FMA: no tensor cores, so no TF32.  Every sum runs in a fixed order
// (no atomics), so two calls give bitwise-equal results.
//
// 'kkt' (iadmm_stage2_step):
//   1. rhs       b̃ = [σx − p ; z − y/ρ]
//   2. gemv      xv = Ã⁻¹·b̃, one warp per row of Ã⁻¹ (Ã⁻¹ is symmetric,
//                so the row-major product stands for the TPU's b̃ᵀ·Ã⁻¹)
//   3. `refine` times: colpass(xv) (kkt_matvec.cuh), r = b̃ − Ã·xv,
//                xv += Ã⁻¹·r
//   4. update    the z-relaxed ADMM update with α = 1.6
//   5. colpass([x; y]) and norms: pr = ‖A0x − z‖, dr = ‖Qx + p + A0ᵀy‖
// 'direct' (iadmm_stage2_direct_step), on the condensed system
// M = Q + σI + A0ᵀdiag(ρ)A0 with the operand P = (M⁻¹)ᵀ formed once by the
// wrapper:
//   1. atpass    A0ᵀ(ρz − y) in column partials; b = σx − p + Σ partials
//   2. gemv      xt = P·b (the TPU's b·M⁻¹)
//   3. `refine` times: r = b − M·xt (condensed_mv below), xt += P·r
//   4. finish    A0·xt (gemv over A0), ν = ρ(A0·xt − z) + y, the update,
//                colpass([x; y]) and norms as in 'kkt'
// 'cg' (iadmm_stage2_cg_step), with the Jacobi diagonal d of M:
//   1. b as in 'direct'; r = b − M·xt (xt warm-started from the previous
//      step); cg_init: p = r/d, rz = rᵀp, ‖b‖ (one CTA per instance)
//   2. `cg_iters` times: condensed_mv(p); cg_ap: Ap, per-CTA partial sums
//      of pᵀAp and rᵀr; cg_update (one CTA per instance): α and the mask,
//      xt += αp, r −= αAp, rz' = rᵀ(r/d), β, p = r/d + βp.  The scalars
//      rz and ‖b‖ and the count of unmasked iterations live on the device,
//      one per instance; the host never reads them.
//   3. finish as in 'direct'.
// condensed_mv(v): colpass([Q; A0], wt = v, wb = 0) gives Q·v (column
// partials) and A0·v in one read of [Q; A0]; atpass(ρ∘A0·v) gives
// A0ᵀ(ρ∘A0·v) in one more read of A0.
//
// Bound on the H100.  'kkt': bytes; each step reads Ã⁻¹ (4·(n+m)² bytes)
// and Q and A0 once per instance: 224 MB for B = 8, about 67 µs at
// 3.35 TB/s.  'direct' and 'cg': operations by bounds.stage2, which reads
// Q and A0 once for all N steps; here every M·v reads [Q; A0] and A0 again
// from device memory (96 MB at B = 8, about 29 µs), so the kernels are
// bytes-limited: about 0.42 GB a 'direct' step at refine 2, and
// (cg_iters + 1) M·v a 'cg' step.  The GEMVs read with 16-byte loads when
// the row length is a multiple of 4.

#include "kkt_matvec.cuh"

namespace {

using namespace iadmm;

constexpr int CG_THREADS = 256;  // cg_ap_kernel's n-slice (stage2_kernel.py)

__global__ void rhs_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ z,
                           const float* __restrict__ p,
                           const float* __restrict__ rho, float sigma,
                           float* __restrict__ bt, int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    bt[idx] = sigma * x[b * n + s] - p[b * n + s];
  } else {
    const int k = b * m + (s - n);
    bt[idx] = z[k] - y[k] / rho[k];
  }
}

// out[b, i] (+)= Σ_j A[b, i, j]·v[b, j] for A (B, rows, cols): one warp per
// row, 8 rows per CTA.
__global__ void gemv_kernel(const float* __restrict__ A,
                            const float* __restrict__ v, float* out, int rows,
                            int cols, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= rows) return;  // whole warp
  const float* a = A + ((size_t)b * rows + row) * cols;
  const float* vb = v + (size_t)b * cols;
  float acc = 0.f;
  if ((cols & 3) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    for (int j = lane; j < cols / 4; j += 32) {
      const float4 x = a4[j], w = v4[j];
      acc = fmaf(x.x, w.x, acc);
      acc = fmaf(x.y, w.y, acc);
      acc = fmaf(x.z, w.z, acc);
      acc = fmaf(x.w, w.w, acc);
    }
  } else {
    for (int j = lane; j < cols; j += 32) acc = fmaf(a[j], vb[j], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    float* o = out + (size_t)b * rows + row;
    *o = accumulate ? *o + acc : acc;
  }
}

inline void gemv(const float* A, const float* v, float* out, int rows,
                 int cols, int accumulate, int B, cudaStream_t s) {
  gemv_kernel<<<dim3((rows + 7) / 8, B), 256, 0, s>>>(A, v, out, rows, cols,
                                                       accumulate);
}

// r = b̃ − Ã·xv from the colpass of xv.
__global__ void refine_kernel(const float* __restrict__ partial,
                              const float* __restrict__ rowdot, int nchunks,
                              const float* __restrict__ xv,
                              const float* __restrict__ bt,
                              const float* __restrict__ rho, float sigma,
                              float* __restrict__ r, int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  float ax;
  if (s < n) {
    ax = kkt::sum_partials(partial, b, nchunks, n, s) + sigma * xv[idx];
  } else {
    const int k = b * m + (s - n);
    ax = rowdot[k] - xv[idx] / rho[k];
  }
  r[idx] = bt[idx] - ax;
}

__global__ void update_kernel(const float* __restrict__ xv,
                              float* __restrict__ x, float* __restrict__ y,
                              float* __restrict__ z,
                              const float* __restrict__ zl,
                              const float* __restrict__ zu,
                              const float* __restrict__ rho, float alpha,
                              int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    const int k = b * n + s;
    x[k] = alpha * xv[idx] + (1.0f - alpha) * x[k];
  } else {
    const int k = b * m + (s - n);
    const float rk = rho[k], yk = y[k], zk = z[k];
    const float zt = zk + (xv[idx] - yk) / rk;
    const float ztmp = alpha * zt + (1.0f - alpha) * zk;
    const float zn = fminf(fmaxf(ztmp + yk / rk, zl[k]), zu[k]);
    y[k] = yk + rk * (ztmp - zn);
    z[k] = zn;
  }
}

// pr[b, i] = ‖A0x − z‖, dr[b, i] = ‖Qx + p + A0ᵀy‖: one CTA per instance.
__global__ void norms_kernel(const float* __restrict__ partial,
                             const float* __restrict__ rowdot, int nchunks,
                             const float* __restrict__ z,
                             const float* __restrict__ p,
                             float* __restrict__ pr, float* __restrict__ dr,
                             int i, int N, int n, int m) {
  __shared__ float red[2][32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float sp = 0.f, sd = 0.f;
  for (int k = tid; k < m; k += blockDim.x) {
    const float v = rowdot[(size_t)b * m + k] - z[(size_t)b * m + k];
    sp = fmaf(v, v, sp);
  }
  for (int j = tid; j < n; j += blockDim.x) {
    const float v =
        kkt::sum_partials(partial, b, nchunks, n, j) + p[(size_t)b * n + j];
    sd = fmaf(v, v, sd);
  }
  sp = warp_sum(sp);
  sd = warp_sum(sd);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sp;
    red[1][tid >> 5] = sd;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      a += red[0][w];
      c += red[1][w];
    }
    pr[(size_t)b * N + i] = sqrtf(a);
    dr[(size_t)b * N + i] = sqrtf(c);
  }
}

// ---- the condensed system ('direct', 'cg') ----

// partial[b, c, j] = Σ_{i in chunk c} A0[b, i, j]·w[b, i] over chunks of
// kkt::ROWS rows of A0, with w = scale∘u − shift (shift may be null).  Each
// element of A0 is read once, neighbouring threads on neighbouring columns;
// the consumer sums the chunks in order (kkt::sum_partials).
constexpr int AT_THREADS = 256;

__global__ void __launch_bounds__(AT_THREADS)
    atpass_kernel(const float* __restrict__ A0, const float* __restrict__ u,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  float* __restrict__ partial, int n, int m, int nchunks) {
  __shared__ float wrow[kkt::ROWS];
  const int b = blockIdx.y, c = blockIdx.x, tid = threadIdx.x;
  const int i0 = c * kkt::ROWS;
  const int rows = min(kkt::ROWS, m - i0);
  if (tid < kkt::ROWS) {
    float v = 0.f;
    if (tid < rows) {
      const size_t k = (size_t)b * m + i0 + tid;
      v = __fmul_rn(scale[k], u[k]);
      if (shift) v -= shift[k];
    }
    wrow[tid] = v;
  }
  __syncthreads();
  const float* Ab = A0 + ((size_t)b * m + i0) * n;
  for (int j = tid; j < n; j += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc = fmaf(Ab[(size_t)r * n + j], wrow[r], acc);
    partial[((size_t)b * nchunks + c) * n + j] = acc;
  }
}

inline int at_chunks(int m) { return (m + kkt::ROWS - 1) / kkt::ROWS; }

inline void atpass(const float* A0, const float* u, const float* scale,
                   const float* shift, float* partial, int n, int m, int B,
                   cudaStream_t s) {
  atpass_kernel<<<dim3(at_chunks(m), B), AT_THREADS, 0, s>>>(
      A0, u, scale, shift, partial, n, m, at_chunks(m));
}

// The column partials of M·v: part_q for Q·v (and rowdot = A0·v), part_a
// for A0ᵀ(ρ∘A0·v).  `zeros` (B, m) stands for wb.
inline void condensed_mv(const void* Q, const float* A0, const float* v,
                         const float* zeros, const float* rho, float* part_q,
                         float* rowdot, float* part_a, int n, int m, int B,
                         cudaStream_t s) {
  kkt::colpass<float, false>(Q, A0, v, n, zeros, m, part_q, rowdot, n, m, B,
                             s);
  atpass(A0, rowdot, rho, nullptr, part_a, n, m, B, s);
}

// b = σx − p + A0ᵀ(ρz − y) from the atpass partials.
__global__ void cond_rhs_kernel(const float* __restrict__ part_a, int na,
                                const float* __restrict__ x,
                                const float* __restrict__ p, float sigma,
                                float* __restrict__ bvec, int n, int B) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n, j = idx % n;
  bvec[idx] =
      (sigma * x[idx] - p[idx]) + kkt::sum_partials(part_a, b, na, n, j);
}

// out = b − M·v from condensed_mv's partials: M·v = (Qv + σv) + A0ᵀ(ρ∘A0v).
__global__ void cond_residual_kernel(const float* __restrict__ part_q,
                                     int nq, const float* __restrict__ part_a,
                                     int na, const float* __restrict__ v,
                                     const float* __restrict__ bvec,
                                     float sigma, float* __restrict__ out,
                                     int n, int B) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n, j = idx % n;
  float mv = kkt::sum_partials(part_q, b, nq, n, j) + sigma * v[idx];
  mv += kkt::sum_partials(part_a, b, na, n, j);
  out[idx] = bvec[idx] - mv;
}

// ν = ρ(A0·xt − z) + y and the z-relaxed update with α (update_kernel's,
// from xt and ν).
__global__ void cond_update_kernel(const float* __restrict__ xt,
                                   const float* __restrict__ a0xt,
                                   float* __restrict__ x,
                                   float* __restrict__ y,
                                   float* __restrict__ z,
                                   const float* __restrict__ zl,
                                   const float* __restrict__ zu,
                                   const float* __restrict__ rho,
                                   float alpha, int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    const int k = b * n + s;
    x[k] = alpha * xt[k] + (1.0f - alpha) * x[k];
  } else {
    const int k = b * m + (s - n);
    const float rk = rho[k], yk = y[k], zk = z[k];
    const float nu = rk * (a0xt[k] - zk) + yk;
    const float zt = zk + (nu - yk) / rk;
    const float ztmp = alpha * zt + (1.0f - alpha) * zk;
    const float zn = fminf(fmaxf(ztmp + yk / rk, zl[k]), zu[k]);
    y[k] = yk + rk * (ztmp - zn);
    z[k] = zn;
  }
}

// cg_init, one CTA per instance: p = r/d, scal = [rᵀp, ‖b‖ + 1e-30].
__global__ void cg_init_kernel(const float* __restrict__ r,
                               const float* __restrict__ bvec,
                               const float* __restrict__ diag,
                               float* __restrict__ pv,
                               float* __restrict__ scal, int n) {
  __shared__ float red[33];
  const int b = blockIdx.x;
  float s_rz = 0.f, s_bb = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const size_t k = (size_t)b * n + j;
    const float zp = r[k] / diag[k];
    pv[k] = zp;
    s_rz = fmaf(r[k], zp, s_rz);
    s_bb = fmaf(bvec[k], bvec[k], s_bb);
  }
  const float rz = block_sum(s_rz, red);
  const float bb = block_sum(s_bb, red);
  if (threadIdx.x == 0) {
    scal[2 * b] = rz;
    scal[2 * b + 1] = sqrtf(bb) + 1e-30f;
  }
}

// Ap = (Qp + σp) + A0ᵀ(ρ∘A0p) from condensed_mv's partials; each CTA of
// CG_THREADS columns writes its partial sums of pᵀAp and rᵀr to dots.
__global__ void __launch_bounds__(CG_THREADS)
    cg_ap_kernel(const float* __restrict__ part_q, int nq,
                 const float* __restrict__ part_a, int na,
                 const float* __restrict__ pv, const float* __restrict__ r,
                 float sigma, float* __restrict__ ap,
                 float* __restrict__ dots, int n) {
  __shared__ float red[33];
  const int b = blockIdx.y;
  const int j = blockIdx.x * CG_THREADS + threadIdx.x;
  float d_pap = 0.f, d_rr = 0.f;
  if (j < n) {
    const size_t k = (size_t)b * n + j;
    float v = kkt::sum_partials(part_q, b, nq, n, j) + sigma * pv[k];
    v += kkt::sum_partials(part_a, b, na, n, j);
    ap[k] = v;
    d_pap = pv[k] * v;
    d_rr = r[k] * r[k];
  }
  d_pap = block_sum(d_pap, red);
  d_rr = block_sum(d_rr, red);
  if (threadIdx.x == 0) {
    float* o = dots + ((size_t)b * gridDim.x + blockIdx.x) * 2;
    o[0] = d_pap;
    o[1] = d_rr;
  }
}

// One CG iteration's updates, one CTA per instance (the TPU kernel's cg
// body): the mask, α, xt += αp, r −= αAp, rz' = rᵀ(r/d), β, p = r/d + βp.
__global__ void cg_update_kernel(const float* __restrict__ dots, int nblk,
                                 const float* __restrict__ ap,
                                 const float* __restrict__ diag, float tol,
                                 float* __restrict__ xt, float* __restrict__ r,
                                 float* __restrict__ pv,
                                 float* __restrict__ scal,
                                 int* __restrict__ iters, int n) {
  __shared__ float red[33];
  const int b = blockIdx.x;
  float denom = 0.f, rr = 0.f;
  for (int c = 0; c < nblk; ++c) {
    denom += dots[((size_t)b * nblk + c) * 2];
    rr += dots[((size_t)b * nblk + c) * 2 + 1];
  }
  const float rz = scal[2 * b], bnorm = scal[2 * b + 1];
  const bool active = (sqrtf(rr) / bnorm > tol) && (denom > 0.f);
  const float a = active ? rz / (denom == 0.f ? 1.f : denom) : 0.f;
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const size_t k = (size_t)b * n + j;
    xt[k] = xt[k] + a * pv[k];
    const float rn = r[k] - a * ap[k];
    r[k] = rn;
    s = fmaf(rn, rn / diag[k], s);
  }
  const float rz_new = block_sum(s, red);
  const float beta = active ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const size_t k = (size_t)b * n + j;
    pv[k] = r[k] / diag[k] + beta * pv[k];
  }
  if (threadIdx.x == 0) {
    scal[2 * b] = active ? rz_new : rz;
    iters[b] += active ? 1 : 0;
  }
}

// The operands and scratch of a condensed step, in the C entry points'
// argument order.
struct Condensed {
  const void* Q;
  const float *A0, *p, *zl, *zu, *rho;
  float *x, *y, *z, *xt, *bvec, *r;
  const float* zeros;
  float *part_q, *part_a, *rowdot;
  int B, n, m;
  float sigma, alpha;
  cudaStream_t s;

  int eblocks(int len) const { return (B * len + 255) / 256; }
  int nq() const { return kkt::n_chunks(n, m); }
  int na() const { return at_chunks(m); }

  // bvec = σx − p + A0ᵀ(ρz − y)
  void rhs() const {
    atpass(A0, z, rho, y, part_a, n, m, B, s);
    cond_rhs_kernel<<<eblocks(n), 256, 0, s>>>(part_a, na(), x, p, sigma,
                                               bvec, n, B);
  }

  // r = bvec − M·v
  void residual(const float* v) const {
    condensed_mv(Q, A0, v, zeros, rho, part_q, rowdot, part_a, n, m, B, s);
    cond_residual_kernel<<<eblocks(n), 256, 0, s>>>(
        part_q, nq(), part_a, na(), v, bvec, sigma, r, n, B);
  }

  // ν from xt, the update, and the step's residual norms.
  void finish(int i, int N, float* pr, float* dr) const {
    gemv(A0, xt, rowdot, m, n, 0, B, s);
    cond_update_kernel<<<eblocks(n + m), 256, 0, s>>>(
        xt, rowdot, x, y, z, zl, zu, rho, alpha, n, m, B);
    kkt::colpass<float, false>(Q, A0, x, n, y, m, part_q, rowdot, n, m, B,
                               s);
    norms_kernel<<<B, 256, 0, s>>>(part_q, rowdot, nq(), z, p, pr, dr, i, N,
                                   n, m);
  }
};

}  // namespace

extern "C" {

// Polish step i of N, solver 'kkt'.  All float32.  Q (B,n,n), A0 (B,m,n),
// Ainv (B,n+m,n+m), p (B,n), zl, zu, rho (B,m).  x (B,n), y, z (B,m) are
// updated in place; xv (B,n+m) receives the solve.  bt, r (B,n+m),
// mv_partial (B, ceil((n+m)/32), n) and rowdot (B,m) are scratch.  pr, dr:
// (B, N).
int iadmm_stage2_step(int i, int N, int refine, const void* Q, const void* A0,
                      const void* Ainv, const void* p, const void* zl,
                      const void* zu, const void* rho, void* x, void* y,
                      void* z, void* xv, void* bt, void* r, void* mv_partial,
                      void* rowdot, void* pr, void* dr, int B, int n, int m,
                      float sigma, float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n + m;
  const int nch = kkt::n_chunks(n, m);
  const int eblocks = (B * S + 255) / 256;
  const float* A = static_cast<const float*>(Ainv);
  const float* pf = static_cast<const float*>(p);
  const float* rf = static_cast<const float*>(rho);
  float* xf = static_cast<float*>(x);
  float* yf = static_cast<float*>(y);
  float* zf = static_cast<float*>(z);
  float* xvf = static_cast<float*>(xv);
  float* btf = static_cast<float*>(bt);
  float* res = static_cast<float*>(r);
  float* part = static_cast<float*>(mv_partial);
  float* rd = static_cast<float*>(rowdot);

  rhs_kernel<<<eblocks, 256, 0, s>>>(xf, yf, zf, pf, rf, sigma, btf, n, m, B);
  gemv(A, btf, xvf, S, S, 0, B, s);
  for (int k = 0; k < refine; ++k) {
    kkt::colpass<float, false>(Q, A0, xvf, S, xvf + n, S, part, rd, n, m, B,
                               s);
    refine_kernel<<<eblocks, 256, 0, s>>>(part, rd, nch, xvf, btf, rf, sigma,
                                          res, n, m, B);
    gemv(A, res, xvf, S, S, 1, B, s);
  }
  update_kernel<<<eblocks, 256, 0, s>>>(
      xvf, xf, yf, zf, static_cast<const float*>(zl),
      static_cast<const float*>(zu), rf, alpha, n, m, B);
  kkt::colpass<float, false>(Q, A0, xf, n, yf, m, part, rd, n, m, B, s);
  norms_kernel<<<B, 256, 0, s>>>(part, rd, nch, zf, pf,
                                 static_cast<float*>(pr),
                                 static_cast<float*>(dr), i, N, n, m);
  return static_cast<int>(cudaGetLastError());
}

// Polish step i of N, solver 'direct'.  All float32.  Q (B,n,n), A0 (B,m,n),
// P = (M⁻¹)ᵀ (B,n,n), p (B,n), zl, zu, rho (B,m).  x, xt (B,n), y, z (B,m)
// are updated in place.  Scratch: bvec, r (B,n), zeros (B,m, all 0),
// part_q (B, ceil((n+m)/32), n), part_a (B, ceil(m/32), n), rowdot (B,m).
// pr, dr: (B, N).
int iadmm_stage2_direct_step(int i, int N, int refine, const void* Q,
                             const void* A0, const void* P, const void* p,
                             const void* zl, const void* zu, const void* rho,
                             void* x, void* y, void* z, void* xt, void* bvec,
                             void* r, const void* zeros, void* part_q,
                             void* part_a, void* rowdot, void* pr, void* dr,
                             int B, int n, int m, float sigma, float alpha,
                             void* stream) {
  const Condensed c{Q,
                    static_cast<const float*>(A0),
                    static_cast<const float*>(p),
                    static_cast<const float*>(zl),
                    static_cast<const float*>(zu),
                    static_cast<const float*>(rho),
                    static_cast<float*>(x),
                    static_cast<float*>(y),
                    static_cast<float*>(z),
                    static_cast<float*>(xt),
                    static_cast<float*>(bvec),
                    static_cast<float*>(r),
                    static_cast<const float*>(zeros),
                    static_cast<float*>(part_q),
                    static_cast<float*>(part_a),
                    static_cast<float*>(rowdot),
                    B, n, m, sigma, alpha,
                    static_cast<cudaStream_t>(stream)};
  const float* Pf = static_cast<const float*>(P);
  c.rhs();
  gemv(Pf, c.bvec, c.xt, n, n, 0, B, c.s);
  for (int k = 0; k < refine; ++k) {
    c.residual(c.xt);
    gemv(Pf, c.r, c.xt, n, n, 1, B, c.s);
  }
  c.finish(i, N, static_cast<float*>(pr), static_cast<float*>(dr));
  return static_cast<int>(cudaGetLastError());
}

// Polish step i of N, solver 'cg'.  As iadmm_stage2_direct_step, with the
// Jacobi diagonal diag (B,n) in place of P, and further scratch: pv, ap
// (B,n), dots (B, ceil(n/256), 2), scal (B,2).  xt carries the warm start
// across steps; iters (B,) int32 counts the unmasked CG iterations.
int iadmm_stage2_cg_step(int i, int N, int cg_iters, const void* Q,
                         const void* A0, const void* diag, const void* p,
                         const void* zl, const void* zu, const void* rho,
                         void* x, void* y, void* z, void* xt, void* bvec,
                         void* r, const void* zeros, void* part_q,
                         void* part_a, void* rowdot, void* pv, void* ap,
                         void* dots, void* scal, void* iters, void* pr,
                         void* dr, int B, int n, int m, float sigma,
                         float tol, float alpha, void* stream) {
  const Condensed c{Q,
                    static_cast<const float*>(A0),
                    static_cast<const float*>(p),
                    static_cast<const float*>(zl),
                    static_cast<const float*>(zu),
                    static_cast<const float*>(rho),
                    static_cast<float*>(x),
                    static_cast<float*>(y),
                    static_cast<float*>(z),
                    static_cast<float*>(xt),
                    static_cast<float*>(bvec),
                    static_cast<float*>(r),
                    static_cast<const float*>(zeros),
                    static_cast<float*>(part_q),
                    static_cast<float*>(part_a),
                    static_cast<float*>(rowdot),
                    B, n, m, sigma, alpha,
                    static_cast<cudaStream_t>(stream)};
  const float* d = static_cast<const float*>(diag);
  float* pvf = static_cast<float*>(pv);
  float* apf = static_cast<float*>(ap);
  float* dotf = static_cast<float*>(dots);
  float* sc = static_cast<float*>(scal);
  const int nblk = (n + CG_THREADS - 1) / CG_THREADS;
  c.rhs();
  c.residual(c.xt);
  cg_init_kernel<<<B, 256, 0, c.s>>>(c.r, c.bvec, d, pvf, sc, n);
  for (int k = 0; k < cg_iters; ++k) {
    condensed_mv(Q, c.A0, pvf, c.zeros, c.rho, c.part_q, c.rowdot, c.part_a,
                 n, m, B, c.s);
    cg_ap_kernel<<<dim3(nblk, B), CG_THREADS, 0, c.s>>>(
        c.part_q, c.nq(), c.part_a, c.na(), pvf, c.r, sigma, apf, dotf, n);
    cg_update_kernel<<<B, 256, 0, c.s>>>(dotf, nblk, apf, d, tol, c.xt, c.r,
                                         pvf, sc, static_cast<int*>(iters),
                                         n);
  }
  c.finish(i, N, static_cast<float*>(pr), static_cast<float*>(dr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
