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
//   cell adjoint  cell_bwd_bf16 / cell_bwd_f32: the forward's gate GEMM
//                 H_k·U recomputed (cell_gemm.cuh's tiles: 128 tokens × the
//                 i, f, o, u columns of 32 hidden units, on hopper.cuh's
//                 wgmma core or gemm_f32.cuh's float32 FFMA core), staged
//                 in shared memory, with an epilogue that forms
//                 dH' = sH + ddel·W_hᵀ, dC' and the four dpre quarters, writes
//                 dpre (in the compute dtype), sC ← dC'·f, and per-tile
//                 partial sums for dxv, dg (rows) and db, dW, dW_h (columns)
//   dH = dpre·Uᵀ  into sH                 (gemm_bf16.cuh; float32:
//                 gemm_f32.cuh on the transposed copies dpreᵀ and Uᵀ)
//   dU += H_kᵀ·dpre                        (gemm_bf16.cuh / gemm_f32.cuh)
//   reductions    the column partials into db, dW, dW_h; the row partials
//                 into dxv and dg
//   vector tail   admm::kkt_apply twice (dr = Ã·dg, [du; dν] = Ã·dr), the
//                 dx/dy/dz/dρ updates (tail_kernel), and dρ_t, dα_t at slot
//                 k with the db_h step (sched_kernel)
//
// Every sum over tokens, instances or tiles has a fixed order: each output
// element is owned by one thread, partials are summed in tile order, and no
// float atomics are used, so two runs give bitwise-equal gradients.  Two
// compute dtypes (the entry point's f32 flag), as in train_fwd.cu.  In the
// bf16 one the rounding points are the TPU kernel's: dpre before the dU and
// dH products (train_rollout.py:586), ddel before dH' and dW_h (:563-569),
// the vectors before every matvec; db, dW, dxv and dg use float32 dpre
// (:590-603); the three GEMMs run on the tensor cores (wgmma, TMA rings).
// The float32 one rounds nothing: dpre is stored in float32 and the three
// GEMMs run on the CUDA cores (FFMA, no TF32).  The clip mask
// z_t + y/ρ ∈ [zl, zu] is inclusive at both ends (:510-511).
//
// Bound on the H100 at B=2, S=2000, h=800, J=100: three GEMMs a step,
// J·3·2·B·S·h·4h = 6.14 TFLOP, 6.21 ms at 989 TFLOP/s (bf16) or 91.7 ms at
// 67 TFLOP/s (float32), against 1.92 GB (bf16 H) or 2.56 GB (float32 H) of
// streams read back (0.57 / 0.76 ms at 3.35 TB/s): operations.
//
// iadmm_train_bwd_seg replaces _bwd_seg_kernel, the backward of the segment
// route: one call per segment, in reverse over the chunk, recomputes the
// segment's J steps from its checkpoint into a (J+1)-slot buffer with
// admm_step.cuh's iteration (the forward's launches without the losses),
// then runs the reverse steps above over that buffer.  Four GEMMs a step
// (the recompute's and the three of the reverse step): about one forward
// more than the stream backward, for a buffer of J+1 slots instead of a
// chunk's streams.

#include "admm_step.cuh"
#include "cell_gemm.cuh"
#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"

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
                            const float* __restrict__ ddr, int col, int L,
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
  const float c1 = dpr[b * L + col] / fmaxf(sqrtf(s1), 1e-30f);
  const float c2 = ddr[b * L + col] / fmaxf(sqrtf(s2), 1e-30f);
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

// The cell adjoint of train_rollout.py:553-620 for the float32 tile
// (blockIdx.y·BM, blockIdx.x·HB_F32): recompute the gate pre-activations on
// cell_gemm.cuh's float32 core, form dpre and the carries, write the
// partial sums (see the header): the row partials one per 16-unit group
// (two 8-unit chains, added), the column partials per 128-row tile in row
// order.  dpre is written twice, as (M, 4h) and transposed as dpreT (4h,
// M), so that both weight-side GEMMs read their operands along rows.
// ddel = −dxv (after the update adjoint).  T: the compute dtype of H, the
// weights and dpre (float).
template <typename T, bool VEC>
__global__ void __launch_bounds__(cell::THREADS32, cell::T32::CTAS)
    cell_bwd_f32(const T* __restrict__ H_k, const T* __restrict__ H_n,
                    const float* __restrict__ C_k,
                    const float* __restrict__ C_n,
                    const float* __restrict__ xv_k,
                    const float* __restrict__ g,
                    const float* __restrict__ dxv,
                    const T* __restrict__ W, const T* __restrict__ U,
                    const float* __restrict__ bias,
                    const T* __restrict__ Wh, const float* __restrict__ sH,
                    float* __restrict__ sC, T* __restrict__ dpre,
                    float* __restrict__ dpreT,
                    float* __restrict__ pxv, float* __restrict__ pg,
                    float* __restrict__ pdb, float* __restrict__ pdw0,
                    float* __restrict__ pdw1, float* __restrict__ pdwh,
                    int M, int h) {
  using cell::BM;
  using cell::DELTA_HB;
  constexpr int HB = cell::HB_F32;
  constexpr int LDC = cell::LDC32;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float xs_s[BM], gs_s[BM], dd_s[BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int u0 = blockIdx.x * HB;
  const int h4 = 4 * h;
  const int rows = min(BM, M - m0);
  static_assert(cell::THREADS32 >= 5 * HB && cell::THREADS32 >= BM,
                "a thread a row, then a column or a unit");
  if (tid < BM) {
    const int gr = m0 + tid;
    const bool ok = gr < M;
    xs_s[tid] = ok ? xv_k[gr] : 0.f;
    gs_s[tid] = ok ? g[gr] : 0.f;
    dd_s[tid] = ok ? as_operand<T>(-dxv[gr]) : 0.f;
  }
  cell::mainloop32<T, VEC>(H_k, U, M, h, m0, u0, sm);

  // Epilogue: each (row r, 16-unit group half) of the tile, a thread each
  // (one pass; a loop for cell_gemm.cuh's reason).
  for (int p = tid; p < 2 * BM; p += cell::THREADS32) {
    const int r = p >> 1;
    const int half = p & 1;
    const int gr = m0 + r;
    float axv[2] = {0.f, 0.f}, ag[2] = {0.f, 0.f};
    if (gr < M) {
      const float a0 = xs_s[r], a1 = gs_s[r], dd = dd_s[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll 1
        for (int jj = 0; jj < 8; ++jj) {
          const int j = half * DELTA_HB + 8 * c + jj, u = u0 + j;
          if (u >= h) break;
          float pre[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = q * h + u;
            pre[q] = sm[r * LDC + q * HB + j] + a0 * to_f(W[col]) +
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
            dpre[(size_t)gr * h4 + col] = from_f<T>(dp[q]);
            dpreT[(size_t)col * M + gr] = dp[q];
            sm[r * LDC + q * HB + j] = dp[q];
            axv[c] += dp[q] * to_f(W[col]);
            ag[c] += dp[q] * to_f(W[h4 + col]);
          }
        }
      }
    }
    const int grp = blockIdx.x * (HB / DELTA_HB) + half;
    if (gr < M && grp * DELTA_HB < h) {
      pxv[(size_t)grp * M + gr] = axv[0] + axv[1];
      pg[(size_t)grp * M + gr] = ag[0] + ag[1];
    }
  }
  __syncthreads();

  // Column partials over this tile's rows, in row order.
  if (tid < 4 * HB) {
    const int q = tid / HB, j = tid % HB, u = u0 + j;
    if (u < h) {
      float sb = 0.f, s0 = 0.f, s1 = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        const float d = sm[rr * LDC + tid];
        sb += d;
        s0 += xs_s[rr] * d;
        s1 += gs_s[rr] * d;
      }
      const size_t o = (size_t)blockIdx.y * h4 + q * h + u;
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
      pdwh[(size_t)blockIdx.y * h + u] = s;
    }
  }
}

// The cell adjoint for the bf16 tile (blockIdx.y·BM, blockIdx.x·HB_BF16):
// the gate pre-activations recomputed by hopper.cuh's core (A = H_k, B =
// Ut, as in the forward), staged in shared memory over the ring's buffers,
// then cell_bwd_f32's epilogue spread over the CTA's threads: (row, unit)
// pairs form dpre, sC and the dpre quarters in place; then the row
// partials (dxv, dg) and the column partials (db, dW, dW_h), each summed
// by one thread in a fixed order.
using CellBwdShape = hop::Shape<true>;  // H_k: bf16, as the GEMMs' operands

__global__ void __launch_bounds__(CellBwdShape::THREADS, CellBwdShape::CTAS)
    cell_bwd_bf16(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb, hop::Operand a,
                  hop::Operand b, const __nv_bfloat16* __restrict__ H_n,
                  const float* __restrict__ C_k,
                  const float* __restrict__ C_n,
                  const float* __restrict__ xv_k,
                  const float* __restrict__ g,
                  const float* __restrict__ dxv,
                  const __nv_bfloat16* __restrict__ W,
                  const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ Wh,
                  const float* __restrict__ sH, float* __restrict__ sC,
                  __nv_bfloat16* __restrict__ dpre, float* __restrict__ pxv,
                  float* __restrict__ pg, float* __restrict__ pdb,
                  float* __restrict__ pdw0, float* __restrict__ pdw1,
                  float* __restrict__ pdwh, int M, int h) {
  using T = __nv_bfloat16;
  using cell::BM;
  constexpr int HB = cell::HB_BF16;
  constexpr int BN = 4 * HB;
  constexpr int LDS = BN + 4;  // staging row: padded against bank conflicts
  using Shape = CellBwdShape;
  constexpr int NT = Shape::THREADS;
  static_assert(BM * LDS * 4 <= Shape::S * 2 * hop::TILE_BYTES,
                "the staging tile fits in the ring");
  static_assert(BM + BN + HB <= NT, "one thread per row, column, unit");
  extern __shared__ uint8_t smem_raw[];
  __shared__ float xs_s[BM], gs_s[BM], dd_s[BM], w0_s[BN], w1_s[BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int u0 = blockIdx.x * HB;
  const int h4 = 4 * h;
  const int rows = min(BM, M - m0);
  if (tid < BM) {
    const int gr = m0 + tid;
    const bool ok = gr < M;
    xs_s[tid] = ok ? xv_k[gr] : 0.f;
    gs_s[tid] = ok ? g[gr] : 0.f;
    dd_s[tid] = ok ? as_operand<T>(-dxv[gr]) : 0.f;
  } else if (tid < BM + BN) {
    const int c = tid - BM, u = u0 + c % HB, col = (c / HB) * h + u;
    w0_s[c] = u < h ? to_f(W[col]) : 0.f;
    w1_s[c] = u < h ? to_f(W[h4 + col]) : 0.f;
  }
  const hop::Ring ring =
      hop::ring_init<Shape::S, Shape::P>(smem_raw, !a.tma || !b.tma);
  float acc[64];
  hop::mainloop<true, true, Shape::S, Shape::P>(
      &ma, &mb, a, b, m0, blockIdx.x * hop::BN, h, ring, acc);
  __syncthreads();  // every stage consumed: the ring becomes the staging tile
  float* st = reinterpret_cast<float*>(ring.base);
  if (tid < hop::CONSUMERS) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      st[hop::acc_row(i) * LDS + hop::acc_col(i)] = acc[i];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * HB; idx += NT) {
    const int r = idx / HB, j = idx % HB;
    const int gr = m0 + r, u = u0 + j;
    float* sp = st + r * LDS + j;
    if (gr >= M || u >= h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sp[q * HB] = 0.f;
      continue;
    }
    const float a0 = xs_s[r], a1 = gs_s[r], dd = dd_s[r];
    float pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = q * h + u;
      pre[q] = sp[q * HB] + a0 * to_f(W[col]) + a1 * to_f(W[h4 + col]) +
               bias[col];
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
      dpre[(size_t)gr * h4 + q * h + u] = from_f<T>(dp[q]);
      sp[q * HB] = dp[q];
    }
  }
  __syncthreads();

  if (tid < BM) {  // row partials over this tile's units
    const int gr = m0 + tid;
    if (gr < M) {
      float axv = 0.f, ag = 0.f;
      for (int c = 0; c < BN; ++c) {
        const float d = st[tid * LDS + c];
        axv += d * w0_s[c];
        ag += d * w1_s[c];
      }
      pxv[(size_t)blockIdx.x * M + gr] = axv;
      pg[(size_t)blockIdx.x * M + gr] = ag;
    }
  } else if (tid < BM + BN) {  // column partials over this tile's rows
    const int c = tid - BM, q = c / HB, u = u0 + c % HB;
    if (u < h) {
      float sb = 0.f, s0 = 0.f, s1 = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        const float d = st[rr * LDS + c];
        sb += d;
        s0 += xs_s[rr] * d;
        s1 += gs_s[rr] * d;
      }
      const size_t o = (size_t)blockIdx.y * h4 + q * h + u;
      pdb[o] = sb;
      pdw0[o] = s0;
      pdw1[o] = s1;
    }
  } else if (tid < BM + BN + HB) {
    const int u = u0 + tid - BM - BN;
    if (u < h) {
      float s = 0.f;
      for (int rr = 0; rr < rows; ++rr)
        s += to_f(H_n[(size_t)(m0 + rr) * h + u]) * dd_s[rr];
      pdwh[(size_t)blockIdx.y * h + u] = s;
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
// instance, written at slot col; db_h += the step's −Σ dxv (scal[0]).
__global__ void sched_kernel(const float* __restrict__ drv,
                             const float* __restrict__ rhom,
                             const float* __restrict__ dal,
                             const float* __restrict__ scal,
                             const float* __restrict__ rho_raw,
                             const float* __restrict__ alpha_raw, int t,
                             int col, float* __restrict__ drho,
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
    drho[col] = s1 * rt * (1.0f - rt);
    dalpha[col] = s2 * 2.0f * at * (1.0f - at);
    dbh[0] += scal[0];
  }
}

// The cell adjoint's launch for T data and weights; H_k, H_n: slots k and
// k+1 of the H stream.
void cell_bwd(const float* H_k, const float* H_n, const void* Ut,
              const float* C_k, const float* C_n, const float* xv_k,
              const float* g, const float* dxv, const void* W, const void* U,
              const float* b, const void* Wh, const float* sH, float* sC,
              float* dpre, float* dpreT, float* pxv, float* pg, float* pdb,
              float* pdw0, float* pdw1, float* pdwh, int M, int h,
              cudaStream_t s) {
  auto kernel = cell::vec32<float>(H_k, U, h) ? cell_bwd_f32<float, true>
                                              : cell_bwd_f32<float, false>;
  hop::allow_smem(kernel, cell::smem32<float>());
  dim3 grid(cell::n_tiles<float>(h), (M + cell::BM - 1) / cell::BM);
  kernel<<<grid, cell::THREADS32, cell::smem32<float>(), s>>>(
      H_k, H_n, C_k, C_n, xv_k, g, dxv, static_cast<const float*>(W),
      static_cast<const float*>(U), b, static_cast<const float*>(Wh), sH, sC,
      dpre, dpreT, pxv, pg, pdb, pdw0, pdw1, pdwh, M, h);
}
void cell_bwd(const __nv_bfloat16* H_k, const __nv_bfloat16* H_n,
              const void* Ut, const float* C_k, const float* C_n,
              const float* xv_k, const float* g, const float* dxv,
              const void* W, const void* U, const float* b, const void* Wh,
              const float* sH, float* sC, __nv_bfloat16* dpre, float*,
              float* pxv, float* pg, float* pdb, float* pdw0, float* pdw1,
              float* pdwh, int M, int h, cudaStream_t s) {
  hop::Operand a, bo;
  CUtensorMap ma, mb;
  cell::operands(H_k, 0, Ut, M, h, a, bo, &ma, &mb);
  hop::allow_smem(cell_bwd_bf16, CellBwdShape::SMEM);
  dim3 grid(cell::n_tiles<__nv_bfloat16>(h), (M + cell::BM - 1) / cell::BM);
  cell_bwd_bf16<<<grid, CellBwdShape::THREADS, CellBwdShape::SMEM, s>>>(
      ma, mb, a, bo, H_n, C_k, C_n, xv_k, g, dxv,
      static_cast<const __nv_bfloat16*>(W), b,
      static_cast<const __nv_bfloat16*>(Wh), sH, sC, dpre, pxv, pg, pdb,
      pdw0, pdw1, pdwh, M, h);
}

// Reverse step k (slots k and k+1 of the streams) at schedule index t, its
// loss cotangents and dρ, dα at column col of the (B, L) dpr, ddr and the
// (L,) drho, dalpha, with T data and weights (see the entry points).
template <typename T>
int bwd_step(
    int k, int t, int col, int L, const void* Q, const void* A0,
    const void* p, const void* zl, const void* zu, const void* rhom,
    const void* rho_raw, const void* alpha_raw, const void* W, const void* U,
    const void* Ut, const void* b, const void* Wh, const void* hs,
    const void* cs, const void* xs, const void* ys, const void* zs,
    const void* xvs, const void* dpr, const void* ddr, void* dx, void* dy,
    void* dz, void* dxv,
    void* sH, void* sC, void* dW, void* dU, void* db, void* dWh, void* dbh,
    void* drho, void* dalpha, void* r, void* g, void* dv, void* dg, void* drr,
    void* dun, void* drv, void* dal, void* scal, void* mv_partial,
    void* rowdot, void* dpre, void* dpreT, void* pxv, void* pg, void* pdb,
    void* pdw0,
    void* pdw1, void* pdwh, int B, int n, int m, int h, float sigma,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n + m, M = B * S, h4 = 4 * h;
  const int nch = kkt::n_chunks(n, m);
  const int eb = admm::eblocks(M);
  const int n_mt = (M + cell::BM - 1) / cell::BM;
  const int n_rp = cell::n_row_partials<T>(h);
  const size_t slab = (size_t)M * h;
  const auto* hsb = static_cast<const T*>(hs);
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
  auto* dpreb = static_cast<T*>(dpre);

  // vector head
  admm::features<T>(P, t, xv_k, x_k, y_k, z_k, rf, gf, ks, s);
  kkt::colpass<T, admm::kRound<T>>(Q, A0, x_n, n, y_n, m, part, rd, n, m, B,
                                   s);
  head_kernel<<<B, 256, 0, s>>>(part, rd, nch, P.p, z_n,
                                static_cast<const float*>(dpr),
                                static_cast<const float*>(ddr), col, L, dvf,
                                n, m);
  kkt::colpass<T, admm::kRound<T>>(Q, A0, dvf, S, dvf + n, S, part, rd, n, m,
                                   B, s);
  adjoint_kernel<<<eb, 256, 0, s>>>(part, rd, nch, dvf, dxf, dyf, dzf, dxvf,
                                    x_k, y_k, z_k, z_n, xv_n, P.zl, P.zu, rr,
                                    ar, rm, t, drvf, dalf, n, m, B);
  sum_kernel<<<1, 1024, 0, s>>>(dxvf, M, -1.0f, scalf);

  // cell adjoint and the two weight-side GEMMs
  cell_bwd(hsb + k * slab, hsb + (k + 1) * slab, Ut, csf + k * slab,
           csf + (k + 1) * slab, xv_k, gf, dxvf, W, U,
           static_cast<const float*>(b), Wh, static_cast<const float*>(sH),
           static_cast<float*>(sC), dpreb, static_cast<float*>(dpreT),
           static_cast<float*>(pxv),
           static_cast<float*>(pg), static_cast<float*>(pdb),
           static_cast<float*>(pdw0), static_cast<float*>(pdw1),
           static_cast<float*>(pdwh), M, h, s);
  float* sHf = static_cast<float*>(sH);
  float* dUf = static_cast<float*>(dU);
  if constexpr (std::is_same<T, float>::value) {
    // dH = (dpreᵀ)ᵀ·Uᵀ from the transposed copies (Ut is Uᵀ here), and dU,
    // on gemm_f32.cuh's C = AᵀB: every operand read along its rows
    gemm32::launch<false>(static_cast<const float*>(dpreT), M,
                          static_cast<const float*>(Ut), h, sHf, h, M, h,
                          h4, s);
    gemm32::launch<true>(hsb + k * slab, h, dpreb, h4, dUf, h4, h, h4, M, s);
  } else {
    gemm::launch<false, true, false>(dpreb, h4, U, h4, sHf, h, M, h, h4, s);
    gemm::launch<true, false, true>(hsb + k * slab, h, dpreb, h4, dUf, h4, h,
                                    h4, M, s);
  }
  reduce_cols_kernel<<<admm::eblocks(h4), 256, 0, s>>>(
      static_cast<const float*>(pdb), static_cast<const float*>(pdw0),
      static_cast<const float*>(pdw1), static_cast<const float*>(pdwh), n_mt,
      h, static_cast<float*>(db), static_cast<float*>(dW),
      static_cast<float*>(dWh));
  reduce_rows_kernel<<<eb, 256, 0, s>>>(static_cast<const float*>(pxv),
                                        static_cast<const float*>(pg), n_rp,
                                        dxvf, dgf, M);

  // vector tail
  admm::kkt_apply<T>(P, t, dgf, drf, ks, s);
  admm::kkt_apply<T>(P, t, drf, duf, ks, s);
  tail_kernel<<<eb, 256, 0, s>>>(drf, duf, dgf, rf, xv_k, y_k, rr, rm, t,
                                 sigma, dxf, dyf, dzf, dxvf, drvf, n, m, B);
  sched_kernel<<<1, 1024, 0, s>>>(drvf, rm, dalf, scalf, rr, ar, t, col,
                                  static_cast<float*>(drho),
                                  static_cast<float*>(dalpha),
                                  static_cast<float*>(dbh), n, m, B);
  return hop::last_error();
}

// One segment (see iadmm_train_bwd_seg) with T data and weights.
template <typename T>
int bwd_seg(
    int t0, int col, int L, const void* Q, const void* A0, const void* p,
    const void* zl, const void* zu, const void* rhom, const void* rho_raw,
    const void* alpha_raw, const void* W, const void* U, const void* Ut,
    const void* b, const void* Wh, const void* bh, void* hs, void* cs,
    void* xs, void* ys, void* zs, void* xvs, const void* dpr,
    const void* ddr, void* dx, void* dy,
    void* dz, void* dxv, void* sH, void* sC, void* dW, void* dU, void* db,
    void* dWh, void* dbh, void* drho, void* dalpha, void* r, void* g,
    void* dv, void* dg, void* drr, void* dun, void* drv, void* dal,
    void* scal, void* mv_partial, void* rowdot, void* dpre, void* dpreT,
    void* pxv,
    void* pg, void* pdb, void* pdw0, void* pdw1, void* pdwh, int B, int n,
    int m, int h, int J, float sigma, void* stream) {
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
  // the recompute's cell reads Ut for bf16 weights, U for float32 ones
  const admm::Weights w{W, std::is_same<T, float>::value ? U : Ut,
                        static_cast<const float*>(b), Wh,
                        static_cast<const float*>(bh), h};
  const admm::KktScratch ks{static_cast<float*>(mv_partial),
                            static_cast<float*>(rowdot)};
  auto* hst = static_cast<T*>(hs);
  auto* csf = static_cast<float*>(cs);
  auto* xvf = static_cast<float*>(xvs);
  auto* xf = static_cast<float*>(xs);
  auto* yf = static_cast<float*>(ys);
  auto* zf = static_cast<float*>(zs);
  // The recompute: the forward's iterations from the checkpoint in slot 0,
  // without the losses (the TPU kernel's fstep computes none).  pxv is the
  // cell's delta scratch here (cell::n_partials(h) rows, at least one per
  // unit tile); the reverse sweep reuses it.
  for (int k = 0; k < J; ++k) {
    admm::iteration<T>(
        P, w, t0 + k, xvf + (size_t)k * M, xf + (size_t)k * B * n,
        yf + (size_t)k * B * m, zf + (size_t)k * B * m, hst + k * slab,
        csf + k * slab, xvf + (size_t)(k + 1) * M,
        xf + (size_t)(k + 1) * B * n, yf + (size_t)(k + 1) * B * m,
        zf + (size_t)(k + 1) * B * m, hst + (k + 1) * slab,
        csf + (k + 1) * slab, nullptr, static_cast<float*>(r),
        static_cast<float*>(g), static_cast<float*>(pxv), ks, s);
  }
  int err = hop::last_error();
  for (int k = J - 1; k >= 0 && err == 0; --k)
    err = bwd_step<T>(k, t0 + k, col + k, L, Q, A0, p, zl, zu, rhom, rho_raw,
                      alpha_raw, W, U, Ut, b, Wh, hs, cs, xs, ys, zs, xvs, dpr,
                      ddr, dx, dy, dz, dxv, sH, sC, dW, dU, db, dWh, dbh, drho,
                      dalpha, r, g, dv, dg, drr, dun, drv, dal, scal,
                      mv_partial, rowdot, dpre, dpreT, pxv, pg, pdb, pdw0,
                      pdw1, pdwh, B, n, m, h, sigma, stream);
  return err;
}

}  // namespace

extern "C" {

// Reverse step k (schedule index t).  Data, weights (Ut included) and
// streams as in train_fwd.cu (slots k and k+1 read): bf16, or float32 when
// f32.  dpr, ddr
// (B, J): the cotangents of the losses.  Carries, updated in place: dx
// (B,n), dy, dz (B,m), dxv (B,n+m), sH, sC (B·(n+m), h) float32.
// Accumulators, added to: dW (2,4h), dU (h,4h), db (4h,), dWh (h,), dbh
// (1,); drho, dalpha (J,): slot k written.  The rest is scratch: r, g, dv,
// dg, drr, dun (B,n+m), drv (B,m), dal (B,n), scal (1,), mv_partial
// (B, ceil((n+m)/32), n), rowdot (B,m), dpre (B·(n+m), 4h) in the dtype of
// Q, dpreT (4h, B·(n+m)) float32 (read only when f32: dpre transposed, the
// float32 dH's operand, beside Ut = Uᵀ (4h, h) for float32 weights), pxv
// (cell::n_partials(h), B·(n+m)), pg (cell::n_row_partials<T>(h),
// B·(n+m)), pdb, pdw0, pdw1 (ceil(B·(n+m)/cell::BM), 4h), pdwh
// (ceil(B·(n+m)/cell::BM), h).
int iadmm_train_bwd_step(
    int k, int t, const void* Q, const void* A0, const void* p,
    const void* zl, const void* zu, const void* rhom, const void* rho_raw,
    const void* alpha_raw, const void* W, const void* U, const void* Ut,
    const void* b, const void* Wh, const void* hs, const void* cs,
    const void* xs, const void* ys, const void* zs, const void* xvs,
    const void* dpr, const void* ddr, void* dx, void* dy, void* dz,
    void* dxv, void* sH,
    void* sC, void* dW, void* dU, void* db, void* dWh, void* dbh, void* drho,
    void* dalpha, void* r, void* g, void* dv, void* dg, void* drr, void* dun,
    void* drv, void* dal, void* scal, void* mv_partial, void* rowdot,
    void* dpre, void* dpreT, void* pxv, void* pg, void* pdb, void* pdw0,
    void* pdw1,
    void* pdwh, int B, int n, int m, int h, int J, int f32, float sigma,
    void* stream) {
  auto run = f32 ? &bwd_step<float> : &bwd_step<__nv_bfloat16>;
  return run(k, t, k, J, Q, A0, p, zl, zu, rhom, rho_raw, alpha_raw, W, U, Ut,
             b, Wh, hs, cs, xs, ys, zs, xvs, dpr, ddr, dx, dy, dz, dxv, sH, sC,
             dW, dU, db, dWh, dbh, drho, dalpha, r, g, dv, dg, drr, dun, drv,
             dal, scal, mv_partial, rowdot, dpre, dpreT, pxv, pg, pdb, pdw0,
             pdw1, pdwh, B, n, m, h, sigma, stream);
}

// Replaces _bwd_seg_kernel (train_rollout.py:664): one segment of J steps,
// schedule indices t0 … t0+J−1, of the segment route's backward.  hs
// (J+1, B·S, h) in the dtype of Q, cs (J+1, B·S, h), xs (J+1,B,n), ys, zs
// (J+1,B,m), xvs (J+1,B,S) float32: the segment buffer, its slot 0 the
// segment's checkpoint (H rounded as the gate GEMM consumes it); bh (1,)
// float32.  First the recompute: J forward iterations of admm_step.cuh
// fill slots 1 … J (no losses).  Then J reverse steps of iadmm_train_bwd_step
// over that buffer, k = J−1 … 0, with dpr, ddr (B, L) read at column col + k
// and dρ, dα written at col + k of drho, dalpha (L,).  The carries dx … sC
// enter as the cotangents of the segment's final state and leave as those
// of its start state; dW … dbh are added to in place, so over the segments
// of a chunk, in reverse, they take the same sums in the same order as the
// stream route: on the same inputs the two give bitwise-equal gradients.
// Data, weights, carries, accumulators and scratch as in
// iadmm_train_bwd_step.
int iadmm_train_bwd_seg(
    int t0, int col, int L, const void* Q, const void* A0, const void* p,
    const void* zl, const void* zu, const void* rhom, const void* rho_raw,
    const void* alpha_raw, const void* W, const void* U, const void* Ut,
    const void* b, const void* Wh, const void* bh, void* hs, void* cs,
    void* xs, void* ys, void* zs, void* xvs, const void* dpr,
    const void* ddr, void* dx, void* dy,
    void* dz, void* dxv, void* sH, void* sC, void* dW, void* dU, void* db,
    void* dWh, void* dbh, void* drho, void* dalpha, void* r, void* g,
    void* dv, void* dg, void* drr, void* dun, void* drv, void* dal,
    void* scal, void* mv_partial, void* rowdot, void* dpre, void* dpreT,
    void* pxv,
    void* pg, void* pdb, void* pdw0, void* pdw1, void* pdwh, int B, int n,
    int m, int h, int J, int f32, float sigma, void* stream) {
  auto run = f32 ? &bwd_seg<float> : &bwd_seg<__nv_bfloat16>;
  return run(t0, col, L,  Q, A0, p, zl, zu, rhom, rho_raw, alpha_raw, W, U, Ut,
             b, Wh, bh, hs, cs, xs, ys, zs, xvs, dpr, ddr, dx, dy, dz, dxv, sH,
             sC, dW, dU, db, dWh, dbh, drho, dalpha, r, g, dv, dg, drr, dun,
             drv, dal, scal, mv_partial, rowdot, dpre, dpreT, pxv, pg, pdb,
             pdw0, pdw1, pdwh, B, n, m, h, J, sigma, stream);
}

// The weight-side GEMM core alone, for timing and checking it: C (M, N)
// (=|+=) A·B over K in bf16 with float32 sums, with the operands and flags
// of bwd_step's two products: dH (a_col 0, b_col 1, acc 0) or dU (a_col 1,
// b_col 0, acc 1); gemm_bf16.cuh has A_COL, B_COL.  Other flags:
// cudaErrorInvalidValue.
int iadmm_gemm_bf16(int a_col, int b_col, int acc, const void* A, int lda,
                    const void* B, int ldb, void* C, int ldc, int M, int N,
                    int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* Cf = static_cast<float*>(C);
  if (!a_col && b_col && !acc)
    gemm::launch<false, true, false>(A, lda, B, ldb, Cf, ldc, M, N, K, s);
  else if (a_col && !b_col && acc)
    gemm::launch<true, false, true>(A, lda, B, ldb, Cf, ldc, M, N, K, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return hop::last_error();
}

// The float32 GEMM core alone, for timing and checking it: C (M, N)
// (=|+=) AᵀB over K in float32 FFMA, A (K, M) and B (K, N) row-major, the
// form of bwd_step's two float32 products: dH from the transposed copies
// (acc 0) and dU (acc 1).  Any leading dimension, 4-byte aligned
// addresses.  a_col must be 1 and b_col 0: otherwise
// cudaErrorInvalidValue.
int iadmm_gemm_f32(int a_col, int b_col, int acc, const void* A, int lda,
                   const void* B, int ldb, void* C, int ldc, int M, int N,
                   int K, void* stream) {
  if (!a_col || b_col) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = acc ? &gemm32::launch<true> : &gemm32::launch<false>;
  run(static_cast<const float*>(A), lda, static_cast<const float*>(B), ldb,
      static_cast<float*>(C), ldc, M, N, K, s);
  return hop::last_error();
}

}  // extern "C"
