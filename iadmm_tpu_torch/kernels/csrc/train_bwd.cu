// One reverse step of the TBPTT training chunk's hand-derived backward, for
// Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/train_rollout.py::_bwd_stream_kernel (built by
// make_fused_chunk_loss(stream=True)).  The TPU kernel sweeps k = J−1 … 0
// over the streams its forward wrote (no recompute of the forward), one
// instance per grid step, summing the weight gradients over the steps and
// the instances in VMEM.  Here the host calls this entry point once per
// reverse step k; it reads the streams of train_fwd.cu (slots k and k+1) and
// launches, in order:
//   vector head   admm::features (r = Ã·xv − b̃, g = Ã·r, recomputed),
//                 colpass over (x', y') and the loss adjoint (head_kernel),
//                 colpass over (dv2, dv1), the ADMM-update adjoint
//                 (adjoint_kernel) and −Σ dxv for db_h (sum_kernel)
//   cell adjoint  cell_bwd_kernel: the forward's gate GEMM H_k·U recomputed
//                 (cell_gemm.cuh's main loop: 128 tokens × the i, f, o, u
//                 columns of 16 hidden units), with an epilogue that forms
//                 dH' = sH + ddel·W_hᵀ, dC' and the four dpre quarters, writes
//                 dpre (bf16), sC ← dC'·f, and per-tile partial sums for
//                 dxv, dg (rows) and db, dW, dW_h (columns)
//   dH = dpre·Uᵀ  into sH                          (gemm_bf16.cuh)
//   dU += H_kᵀ·dpre                                 (gemm_bf16.cuh)
//   reductions    the column partials into db, dW, dW_h; the row partials
//                 into dxv and dg
//   vector tail   admm::kkt_apply twice (dr = Ã·dg, [du; dν] = Ã·dr), the
//                 dx/dy/dz/dρ updates (tail_kernel), and dρ_t, dα_t at slot
//                 k with the db_h step (sched_kernel)
//
// Every sum over tokens, instances or tiles has a fixed order: each output
// element is owned by one thread, partials are summed in tile order, and no
// float atomics are used, so two runs give bitwise-equal gradients.  The
// bf16 rounding points are the TPU kernel's: dpre before the dU and dH
// products (train_rollout.py:586), ddel before dH' and dW_h (:563-569), the
// vectors before every matvec; db, dW, dxv and dg use float32 dpre
// (:590-603).  The clip mask z_t + y/ρ ∈ [zl, zu] is inclusive at both ends
// (:510-511).
//
// Bound on the H100 at B=2, S=2000, h=800, J=100: three GEMMs a step,
// J·3·2·B·S·h·4h = 6.14 TFLOP, 6.21 ms at 989 TFLOP/s, against 1.92 GB of
// streams read back (0.57 ms at 3.35 TB/s): operations.

#include "admm_step.cuh"
#include "cell_gemm.cuh"
#include "gemm_bf16.cuh"

namespace {

using namespace iadmm;

// One CTA per instance.  From the colpass over (x', y'): v1 = A0·x' − z',
// v2 = Q·x' + A0ᵀ·y' + p, their norms, and the loss cotangents
// dv = [dv2; dv1] = [ddr/‖v2‖ · v2; dpr/‖v1‖ · v1] in (B, n+m).
__global__ void head_kernel(const float* __restrict__ partial,
                            const float* __restrict__ rowdot, int nchunks,
                            const float* __restrict__ p,
                            const float* __restrict__ z_new,
                            const float* __restrict__ dpr,
                            const float* __restrict__ ddr, int k, int J,
                            float* __restrict__ dv, int n, int m) {
  __shared__ float scratch[33];
  const int b = blockIdx.x, S = n + m;
  float* dvb = dv + (size_t)b * S;
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v2 = kkt::sum_partials(partial, b, nchunks, n, j) + p[b * n + j];
    dvb[j] = v2;
    s2 += v2 * v2;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float v1 = rowdot[b * m + i] - z_new[b * m + i];
    dvb[n + i] = v1;
    s1 += v1 * v1;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  const float c1 = dpr[b * J + k] / fmaxf(sqrtf(s1), 1e-30f);
  const float c2 = ddr[b * J + k] / fmaxf(sqrtf(s2), 1e-30f);
  for (int j = threadIdx.x; j < n; j += blockDim.x) dvb[j] *= c2;
  for (int i = threadIdx.x; i < m; i += blockDim.x) dvb[n + i] *= c1;
}

// The loss and ADMM-update adjoint, elementwise (train_rollout.py:525-546).
// partial/rowdot: the colpass over (dv2, dv1), i.e. Q·dv2 + A0ᵀ·dv1 and
// A0·dv2.  Updates the carries dx, dy, dz and dxv += [dxt; dv_]; writes the
// per-row terms of dρ (drv) and dα (dal).
__global__ void adjoint_kernel(
    const float* __restrict__ partial, const float* __restrict__ rowdot,
    int nchunks, const float* __restrict__ dv, float* __restrict__ dx,
    float* __restrict__ dy, float* __restrict__ dz, float* __restrict__ dxv,
    const float* __restrict__ x_k, const float* __restrict__ y_k,
    const float* __restrict__ z_k, const float* __restrict__ z_n,
    const float* __restrict__ xv_n, const float* __restrict__ zl,
    const float* __restrict__ zu, const float* __restrict__ rho_raw,
    const float* __restrict__ alpha_raw, const float* __restrict__ rhom,
    int t, float* __restrict__ drv, float* __restrict__ dal, int n, int m,
    int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    const int j = b * n + s;
    const float alpha = 2.0f * sigmoidf(alpha_raw[t]);
    const float dxn = dx[j] + kkt::sum_partials(partial, b, nchunks, n, s);
    dal[j] = dxn * (xv_n[idx] - x_k[j]);
    dx[j] = (1.0f - alpha) * dxn;
    dxv[idx] += alpha * dxn;
  } else {
    const int i = b * m + (s - n);
    const float rho = sigmoidf(rho_raw[t]) * rhom[i];
    const float y = y_k[i], v = xv_n[idx];
    const float dyn = dy[i] + rowdot[i];
    const float dzn = dz[i] - dv[idx];
    const float z_t = z_k[i] + (v - y) / rho;
    const float w = z_t + y / rho;
    const bool inside = w >= zl[i] && w <= zu[i];
    float d_rho = dyn * (z_t - z_n[i]);
    float dz_t = rho * dyn;
    const float dw = inside ? -rho * dyn + dzn : 0.f;
    dz_t += dw;
    float dyv = dyn + dw / rho;
    d_rho -= dw * y / (rho * rho);
    dyv -= dz_t / rho;
    d_rho -= dz_t * (v - y) / (rho * rho);
    dz[i] = dz_t;
    dy[i] = dyv;
    drv[i] = d_rho;
    dxv[idx] += dz_t / rho;
  }
}

// out[0] = scale · Σ v[0..count) in a fixed order (one CTA).
__global__ void sum_kernel(const float* __restrict__ v, int count,
                           float scale, float* __restrict__ out) {
  __shared__ float scratch[33];
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += v[i];
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) out[0] = scale * s;
}

// The cell adjoint of train_rollout.py:553-620 for the tile (m0, u0):
// recompute the gate pre-activations, form dpre and the carries, write the
// partial sums (see the header).  ddel = −dxv (after the update adjoint).
__global__ void __launch_bounds__(cell::THREADS)
    cell_bwd_kernel(const __nv_bfloat16* __restrict__ H_k,
                    const __nv_bfloat16* __restrict__ H_n,
                    const float* __restrict__ C_k,
                    const float* __restrict__ C_n,
                    const float* __restrict__ xv_k,
                    const float* __restrict__ g,
                    const float* __restrict__ dxv,
                    const __nv_bfloat16* __restrict__ W,
                    const __nv_bfloat16* __restrict__ U,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ Wh,
                    const float* __restrict__ sH, float* __restrict__ sC,
                    __nv_bfloat16* __restrict__ dpre,
                    float* __restrict__ pxv, float* __restrict__ pg,
                    float* __restrict__ pdb, float* __restrict__ pdw0,
                    float* __restrict__ pdw1, float* __restrict__ pdwh,
                    int M, int h) {
  using cell::BM;
  using cell::HB;
  using cell::LDC;
  __shared__ __align__(128) cell::Smem sm;
  __shared__ float xs_s[BM], gs_s[BM], dd_s[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * HB;
  const int h4 = 4 * h;
  const int rows = min(BM, M - m0);
  if (tid < BM) {
    const int gr = m0 + tid;
    const bool ok = gr < M;
    xs_s[tid] = ok ? xv_k[gr] : 0.f;
    gs_s[tid] = ok ? g[gr] : 0.f;
    dd_s[tid] = ok ? bf16_round(-dxv[gr]) : 0.f;
  }
  cell::mainloop<__nv_bfloat16>(H_k, U, M, h, m0, u0, sm);

  // Epilogue: thread pair (2r, 2r+1) takes row r, 8 units each.
  const int r = tid >> 1;
  const int jb = (tid & 1) * 8;
  const int gr = m0 + r;
  float axv = 0.f, ag = 0.f;
  if (gr < M) {
    const float a0 = xs_s[r], a1 = gs_s[r], dd = dd_s[r];
    for (int jj = 0; jj < 8; ++jj) {
      const int j = jb + jj, u = u0 + j;
      if (u >= h) break;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * h + u;
        pre[q] = sm.C[r * LDC + q * HB + j] + a0 * to_f(W[col]) +
                 a1 * to_f(W[h4 + col]) + bias[col];
      }
      const size_t o = (size_t)gr * h + u;
      const float ig = sigmoidf(pre[0]), fg = sigmoidf(pre[1]);
      const float og = sigmoidf(pre[2]), ug = tanhf(pre[3]);
      const float tC = tanhf(C_n[o]);
      const float dHn = sH[o] + dd * to_f(Wh[u]);
      const float dCn = sC[o] + dHn * og * (1.0f - tC * tC);
      float dp[4];
      dp[2] = dHn * tC * og * (1.0f - og);
      dp[0] = (dCn * ug) * ig * (1.0f - ig);
      dp[3] = (dCn * ig) * (1.0f - ug * ug);
      dp[1] = (dCn * C_k[o]) * fg * (1.0f - fg);
      sC[o] = dCn * fg;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * h + u;
        dpre[(size_t)gr * h4 + col] = __float2bfloat16_rn(dp[q]);
        sm.C[r * LDC + q * HB + j] = dp[q];
        axv += dp[q] * to_f(W[col]);
        ag += dp[q] * to_f(W[h4 + col]);
      }
    }
  }
  axv += __shfl_xor_sync(0xffffffffu, axv, 1);
  ag += __shfl_xor_sync(0xffffffffu, ag, 1);
  if ((tid & 1) == 0 && gr < M) {
    pxv[(size_t)blockIdx.y * M + gr] = axv;
    pg[(size_t)blockIdx.y * M + gr] = ag;
  }
  __syncthreads();

  // Column partials over this tile's rows, in row order.
  if (tid < 4 * HB) {
    const int q = tid / HB, j = tid % HB, u = u0 + j;
    if (u < h) {
      float sb = 0.f, s0 = 0.f, s1 = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        const float d = sm.C[rr * LDC + tid];
        sb += d;
        s0 += xs_s[rr] * d;
        s1 += gs_s[rr] * d;
      }
      const size_t o = (size_t)blockIdx.x * h4 + q * h + u;
      pdb[o] = sb;
      pdw0[o] = s0;
      pdw1[o] = s1;
    }
  } else if (tid < 5 * HB) {
    const int u = u0 + tid - 4 * HB;
    if (u < h) {
      float s = 0.f;
      for (int rr = 0; rr < rows; ++rr)
        s += to_f(H_n[(size_t)(m0 + rr) * h + u]) * dd_s[rr];
      pdwh[(size_t)blockIdx.x * h + u] = s;
    }
  }
}

// db, dW (2 rows), dW_h += the column partials, summed over row tiles in
// order.
__global__ void reduce_cols_kernel(const float* __restrict__ pdb,
                                   const float* __restrict__ pdw0,
                                   const float* __restrict__ pdw1,
                                   const float* __restrict__ pdwh, int ntiles,
                                   int h, float* __restrict__ db,
                                   float* __restrict__ dW,
                                   float* __restrict__ dWh) {
  const int h4 = 4 * h;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h4) return;
  float sb = 0.f, s0 = 0.f, s1 = 0.f, sh = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const size_t o = (size_t)t * h4 + c;
    sb += pdb[o];
    s0 += pdw0[o];
    s1 += pdw1[o];
    if (c < h) sh += pdwh[(size_t)t * h + c];
  }
  db[c] += sb;
  dW[c] += s0;
  dW[h4 + c] += s1;
  if (c < h) dWh[c] += sh;
}

// dxv += Σ_tiles pxv, dg = Σ_tiles pg, in tile order.
__global__ void reduce_rows_kernel(const float* __restrict__ pxv,
                                   const float* __restrict__ pg, int ntiles,
                                   float* __restrict__ dxv,
                                   float* __restrict__ dg, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M) return;
  float a = 0.f, c = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    a += pxv[(size_t)t * M + idx];
    c += pg[(size_t)t * M + idx];
  }
  dxv[idx] += a;
  dg[idx] = c;
}

// The KKT-feature adjoint (train_rollout.py:623-639): drr = [dr1; dr2] =
// Ã·dg, dun = [du; dν] = Ã·drr, r = [r1; r2] of the forward.
__global__ void tail_kernel(const float* __restrict__ drr,
                            const float* __restrict__ dun,
                            const float* __restrict__ dg,
                            const float* __restrict__ r,
                            const float* __restrict__ xv_k,
                            const float* __restrict__ y_k,
                            const float* __restrict__ rho_raw,
                            const float* __restrict__ rhom, int t,
                            float sigma, float* __restrict__ dx,
                            float* __restrict__ dy, float* __restrict__ dz,
                            float* __restrict__ dxv, float* __restrict__ drv,
                            int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    dx[b * n + s] -= sigma * drr[idx];
  } else {
    const int i = b * m + (s - n);
    const float rho = sigmoidf(rho_raw[t]) * rhom[i];
    const float dr2 = drr[idx];
    float d_rho = drv[i] + dg[idx] * r[idx] / (rho * rho);
    dy[i] += dr2 / rho;
    dz[i] -= dr2;
    d_rho += dr2 * (xv_k[idx] - y_k[i]) / (rho * rho);
    drv[i] = d_rho;
  }
  dxv[idx] += dun[idx];
}

// dρ_t = Σ drv·ρ_mult · σ'(ρ_t), dα_t = Σ dal · 2σ'(α_t) over every
// instance, written at slot k; db_h += the step's −Σ dxv (scal[0]).
__global__ void sched_kernel(const float* __restrict__ drv,
                             const float* __restrict__ rhom,
                             const float* __restrict__ dal,
                             const float* __restrict__ scal,
                             const float* __restrict__ rho_raw,
                             const float* __restrict__ alpha_raw, int t,
                             int k, float* __restrict__ drho,
                             float* __restrict__ dalpha,
                             float* __restrict__ dbh, int n, int m, int B) {
  __shared__ float scratch[33];
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < B * m; i += blockDim.x) s1 += drv[i] * rhom[i];
  for (int j = threadIdx.x; j < B * n; j += blockDim.x) s2 += dal[j];
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    const float rt = sigmoidf(rho_raw[t]), at = sigmoidf(alpha_raw[t]);
    drho[k] = s1 * rt * (1.0f - rt);
    dalpha[k] = s2 * 2.0f * at * (1.0f - at);
    dbh[0] += scal[0];
  }
}

}  // namespace

extern "C" {

// Reverse step k (schedule index t).  Data, weights and streams as in
// train_fwd.cu (slots k and k+1 read).  dpr, ddr (B, J): the cotangents of
// the losses.  Carries, updated in place: dx (B,n), dy, dz (B,m), dxv
// (B,n+m), sH, sC (B·(n+m), h) float32.  Accumulators, added to: dW (2,4h),
// dU (h,4h), db (4h,), dWh (h,), dbh (1,); drho, dalpha (J,): slot k
// written.  The rest is scratch: r, g, dv, dg, drr, dun (B,n+m), drv (B,m),
// dal (B,n), scal (1,), mv_partial (B, ceil((n+m)/32), n), rowdot (B,m),
// dpre (B·(n+m), 4h) bf16, pxv, pg (ceil(h/16), B·(n+m)), pdb, pdw0, pdw1
// (ceil(B·(n+m)/128), 4h), pdwh (ceil(B·(n+m)/128), h).
int iadmm_train_bwd_step(
    int k, int t, const void* Q, const void* A0, const void* p,
    const void* zl, const void* zu, const void* rhom, const void* rho_raw,
    const void* alpha_raw, const void* W, const void* U, const void* b,
    const void* Wh, const void* hs, const void* cs, const void* xs,
    const void* ys, const void* zs, const void* xvs, const void* dpr,
    const void* ddr, void* dx, void* dy, void* dz, void* dxv, void* sH,
    void* sC, void* dW, void* dU, void* db, void* dWh, void* dbh, void* drho,
    void* dalpha, void* r, void* g, void* dv, void* dg, void* drr, void* dun,
    void* drv, void* dal, void* scal, void* mv_partial, void* rowdot,
    void* dpre, void* pxv, void* pg, void* pdb, void* pdw0, void* pdw1,
    void* pdwh, int B, int n, int m, int h, int J, float sigma,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n + m, M = B * S, h4 = 4 * h;
  const int nch = kkt::n_chunks(n, m);
  const int eb = admm::eblocks(M);
  const int n_mt = (M + cell::BM - 1) / cell::BM;
  const int n_ut = cell::n_tiles(h);
  const size_t slab = (size_t)M * h;
  const auto* hsb = static_cast<const __nv_bfloat16*>(hs);
  const auto* csf = static_cast<const float*>(cs);
  const float* xv_k = static_cast<const float*>(xvs) + (size_t)k * M;
  const float* x_k = static_cast<const float*>(xs) + (size_t)k * B * n;
  const float* y_k = static_cast<const float*>(ys) + (size_t)k * B * m;
  const float* z_k = static_cast<const float*>(zs) + (size_t)k * B * m;
  const float* xv_n = xv_k + M;
  const float* x_n = x_k + B * n;
  const float* y_n = y_k + B * m;
  const float* z_n = z_k + B * m;
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
  const admm::KktScratch ks{static_cast<float*>(mv_partial),
                            static_cast<float*>(rowdot)};
  const float* rr = P.rho_raw;
  const float* ar = P.alpha_raw;
  const float* rm = P.rhom;
  float* part = ks.partial;
  float* rd = ks.rowdot;
  float* rf = static_cast<float*>(r);
  float* gf = static_cast<float*>(g);
  float* dvf = static_cast<float*>(dv);
  float* dgf = static_cast<float*>(dg);
  float* drf = static_cast<float*>(drr);
  float* duf = static_cast<float*>(dun);
  float* dxf = static_cast<float*>(dx);
  float* dyf = static_cast<float*>(dy);
  float* dzf = static_cast<float*>(dz);
  float* dxvf = static_cast<float*>(dxv);
  float* drvf = static_cast<float*>(drv);
  float* dalf = static_cast<float*>(dal);
  float* scalf = static_cast<float*>(scal);
  auto* dpreb = static_cast<__nv_bfloat16*>(dpre);

  // vector head
  admm::features(P, t, xv_k, x_k, y_k, z_k, rf, gf, ks, s);
  kkt::colpass<__nv_bfloat16, true>(Q, A0, x_n, n, y_n, m, part, rd, n, m, B,
                                    s);
  head_kernel<<<B, 256, 0, s>>>(part, rd, nch, P.p, z_n,
                                static_cast<const float*>(dpr),
                                static_cast<const float*>(ddr), k, J, dvf, n,
                                m);
  kkt::colpass<__nv_bfloat16, true>(Q, A0, dvf, S, dvf + n, S, part, rd, n, m,
                                    B, s);
  adjoint_kernel<<<eb, 256, 0, s>>>(part, rd, nch, dvf, dxf, dyf, dzf, dxvf,
                                    x_k, y_k, z_k, z_n, xv_n, P.zl, P.zu, rr,
                                    ar, rm, t, drvf, dalf, n, m, B);
  sum_kernel<<<1, 1024, 0, s>>>(dxvf, M, -1.0f, scalf);

  // cell adjoint and the two weight-side GEMMs
  dim3 cgrid(n_mt, n_ut);
  cell_bwd_kernel<<<cgrid, cell::THREADS, 0, s>>>(
      hsb + k * slab, hsb + (k + 1) * slab, csf + k * slab,
      csf + (k + 1) * slab, xv_k, gf, dxvf,
      static_cast<const __nv_bfloat16*>(W),
      static_cast<const __nv_bfloat16*>(U), static_cast<const float*>(b),
      static_cast<const __nv_bfloat16*>(Wh), static_cast<const float*>(sH),
      static_cast<float*>(sC), dpreb, static_cast<float*>(pxv),
      static_cast<float*>(pg), static_cast<float*>(pdb),
      static_cast<float*>(pdw0), static_cast<float*>(pdw1),
      static_cast<float*>(pdwh), M, h);
  gemm::launch<false, true, false>(dpreb, h4, U, h4, static_cast<float*>(sH),
                                   h, M, h, h4, s);
  gemm::launch<true, false, true>(hsb + k * slab, h, dpreb, h4,
                                  static_cast<float*>(dU), h4, h, h4, M, s);
  reduce_cols_kernel<<<admm::eblocks(h4), 256, 0, s>>>(
      static_cast<const float*>(pdb), static_cast<const float*>(pdw0),
      static_cast<const float*>(pdw1), static_cast<const float*>(pdwh), n_mt,
      h, static_cast<float*>(db), static_cast<float*>(dW),
      static_cast<float*>(dWh));
  reduce_rows_kernel<<<eb, 256, 0, s>>>(static_cast<const float*>(pxv),
                                        static_cast<const float*>(pg), n_ut,
                                        dxvf, dgf, M);

  // vector tail
  admm::kkt_apply(P, t, dgf, drf, ks, s);
  admm::kkt_apply(P, t, drf, duf, ks, s);
  tail_kernel<<<eb, 256, 0, s>>>(drf, duf, dgf, rf, xv_k, y_k, rr, rm, t,
                                 sigma, dxf, dyf, dzf, dxvf, drvf, n, m, B);
  sched_kernel<<<1, 1024, 0, s>>>(drvf, rm, dalf, scalf, rr, ar, t, k,
                                  static_cast<float*>(drho),
                                  static_cast<float*>(dalpha),
                                  static_cast<float*>(dbh), n, m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
