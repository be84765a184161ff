// One Stage-II exact polish step for Hopper (sm_90a): the solvers 'kkt',
// 'direct' and 'cg'.
//
// Replaces iadmm_tpu/kernels/stage2_kernel.py::_stage2_kernel (driven there
// by fused_stage2).  The TPU kernel runs the N polish steps of one instance
// per grid step with Q, A0 and the solver's operand resident in VMEM.  At
// n = m = 1000 one instance's Q and A0 are 8 MB in float32 and Ã⁻¹ alone is
// 16 MB: far beyond an SM's shared memory, so here each polish step (one C
// call) spreads every instance over many CTAs.  All arithmetic is float32
// FMA on the CUDA cores (no TF32).  Every sum runs in one fixed order, the
// port's first design's (no atomics on a sum): the results are bit for bit
// those of that design.
//
// What bounds it: bytes.  At B = 8 a 'kkt' step reads Ã⁻¹ (128 MB) and
// [Q; A0] (64 MB), 57 µs at 3.35 TB/s; a 'direct' step M⁻¹ three times, A0
// five times and Q three times; a 'cg' step Q and A0 once a CG iteration.
// The first design lost about half of its time beside those reads: chunk
// sums that waited on one load at a time, on 8–32 CTAs; the condensed M·v
// reading A0 twice, once with 4-byte loads; a CG iteration of four
// launches.  This design:
//
// - sum_ahead: Σ_c partial[b, c, j] in chunk order with the loads of the
//   next SUM_AHEAD chunks in flight before this batch's adds; its callers
//   run a column a thread on CTAs of SUM_THREADS, so that the sums of a
//   step run on most SMs.  The residual norms are two kernels: dual_kernel
//   (those sums) and norms_kernel (the first design's strided fmaf chains
//   and warp folds, one CTA an instance, its loads ahead of the chains).
// - the condensed M·v in one read of Q and of A0 (mv_kernel): a Q item (32
//   rows of Q, one instance) forms the column partials of Q·v, each
//   column's fmaf chain down the rows in order, QB rows of loads in flight;
//   an A0 item (32 rows of A0 from A0's row 0, one instance) brings its
//   rows into shared memory in slabs (a bulk copy a row, the next slab in
//   flight), forms each row's dot with v exactly as the KKT pass does
//   (kkt::group_dot, the groups folded in the WAYS interleave: the pass's
//   rowdot, bit for bit), scales it by ρ and runs the A0ᵀ chains down the
//   slab's rows from the same shared memory.  The first design formed Q·v
//   with the pass over [Q; A0] and a zero bottom vector: the A0 rows' terms
//   of those partials are exact zeros (a·0 added to a sum leaves it), and
//   are dropped here.  An A0 item is bound by its own latency (the slab
//   phases each end in a barrier), not by bytes: three CTAs an SM overlap
//   them.
// - a CG iteration is three kernels: mv_kernel; ap_kernel (Ap and each
//   warp's sums of p·Ap and r·r, a column a thread); update_kernel_cg (one
//   CTA an instance: the warp sums folded as cg_ap and cg_update folded
//   them, α and the mask, the update's strided chains with their loads
//   ahead).  A step's 300 launches of its iterations run as one CUDA graph
//   (cg_loop), captured when a call brings a new argument set and replayed
//   while it stays the same.  Measured beside it and dropped: a launch a
//   kernel, and one persistent cooperative launch with a grid barrier
//   between the phases (both slower, same bits).
// - gemv: a warp a row; a lane issues GEMV_AHEAD 16-byte loads of the row
//   and of v before its fmaf chain (its columns j = lane, lane + 32, ... in
//   order; then warp_sum).
// - 'kkt': the update also forms the next step's b̃, so that only the
//   first step launches rhs_kernel.
//
// 'kkt' (iadmm_stage2_step):
//   1. rhs       b̃ = [σx − p ; z − y/ρ] (after the first step, formed by
//                the previous step's update)
//   2. gemv      xv = Ã⁻¹·b̃ (Ã⁻¹ is symmetric, so the row-major product
//                stands for the TPU's b̃ᵀ·Ã⁻¹; the wrapper's operand is
//                row-major, a transposing copy of torch.linalg.inv's
//                column-major result made where it is formed)
//   3. `refine` times: colpass(xv) (kkt_matvec.cuh), r = b̃ − Ã·xv,
//                xv += Ã⁻¹·r
//   4. update    the z-relaxed ADMM update with α = 1.6
//   5. colpass([x; y]) and norms: pr = ‖A0x − z‖, dr = ‖Qx + p + A0ᵀy‖
// 'direct' (iadmm_stage2_direct_step), on the condensed system
// M = Q + σI + A0ᵀdiag(ρ)A0 with the operand P = (M⁻¹)ᵀ formed once by the
// wrapper:
//   1. A0ᵀ(ρz − y) (mv_kernel's A0 items alone); b = σx − p + Σ partials
//   2. gemv      xt = P·b (the TPU's b·M⁻¹)
//   3. `refine` times: r = b − M·xt (mv_kernel), xt += P·r
//   4. finish    A0·xt (gemv over A0), ν = ρ(A0·xt − z) + y, the update,
//                colpass([x; y]) and norms as in 'kkt'
// 'cg' (iadmm_stage2_cg_step), with the Jacobi diagonal d of M:
//   1. b as in 'direct'; r = b − M·xt (xt warm-started from the previous
//      step); cg_init: p = r/d, rz = rᵀp, ‖b‖ (one CTA per instance)
//   2. `cg_iters` times: mv_kernel(p), ap_kernel, update_kernel_cg: α and
//      the mask, xt += αp, r −= αAp, rz' = rᵀ(r/d), β, p = r/d + βp.  The
//      scalars rz and ‖b‖ and the count of unmasked iterations live on the
//      device, one per instance; the host never reads them.
//   3. finish as in 'direct'.
//
// Limit: 'direct' and 'cg' take n up to iadmm_stage2_max_n() (14,368 with
// the H100's 227 KB of shared memory a CTA): an A0 item holds at least two
// rows of A0, v and the chains' sums in shared memory (about 16·n bytes),
// the CG update p, r and d (12·n).  'kkt' has no such limit.

#include <algorithm>
#include <cstring>

#include "kkt_matvec.cuh"

namespace {

using namespace iadmm;

constexpr int THREADS = 256;
constexpr int CG_THREADS = 256;   // columns of a dot's partial sum (cg_ap)
constexpr int UPD_THREADS = 256;  // threads of the update's strided chains
constexpr int SUM_THREADS = 64;   // CTAs of a thread a column's chunk sum
constexpr int CHAIN_AHEAD = 8;    // loads ahead of a strided chain
constexpr int GEMV_AHEAD = 8;     // a lane's 16-byte loads ahead of its chain
constexpr int SUM_AHEAD = 32;     // chunk partials loaded ahead of the adds
constexpr int QB = 16;            // Q rows a thread loads ahead of its chains
constexpr int SLAB = 8;           // most A0 rows a slab
constexpr int NBUF = 2;           // slab buffers: the next slab in flight
constexpr int A0_SMEM = 72 * 1024;   // an A0 item's budget: 3 CTAs an SM
constexpr int MV_CTAS = 3;

// Σ_c partial[b, c, j] in chunk order (kkt::sum_partials' order).  The
// loads of the next SUM_AHEAD chunks are issued before the adds of this
// batch, so that two batches are in flight; the loads are unconditional (a
// chunk past the last reads the last) and the adds selected, so that the
// compiler cannot sink a load into its add's branch.
__device__ __forceinline__ float sum_ahead(const float* partial, int b,
                                           int nchunks, int n, int j) {
  const float* p = partial + (size_t)b * nchunks * n + j;
  float v[SUM_AHEAD], nx[SUM_AHEAD];
#pragma unroll
  for (int k = 0; k < SUM_AHEAD; ++k)
    v[k] = __ldg(p + (size_t)min(k, nchunks - 1) * n);
  float s = 0.f;
  for (int c0 = 0; c0 < nchunks; c0 += SUM_AHEAD) {
    const bool more = c0 + SUM_AHEAD < nchunks;   // uniform
    if (more) {
#pragma unroll
      for (int k = 0; k < SUM_AHEAD; ++k)
        nx[k] = __ldg(p + (size_t)min(c0 + SUM_AHEAD + k, nchunks - 1) * n);
    }
#pragma unroll
    for (int k = 0; k < SUM_AHEAD; ++k) s = c0 + k < nchunks ? s + v[k] : s;
    if (more) {
#pragma unroll
      for (int k = 0; k < SUM_AHEAD; ++k) v[k] = nx[k];
    }
  }
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   hop::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   hop::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 fma4(float4 a, float w, float4 acc) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
  return acc;
}

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

// out[b, i] (+)= Σ_j A[b, i, j]·v[b, j] for A (B, rows, cols): a warp a
// row, 8 rows a CTA.  Lane l's fmaf chain runs over its 16-byte columns
// (4-byte ones where VEC is off) j = l, l + 32, ... in order, then warp_sum;
// its loads of A and v go GEMV_AHEAD at a time ahead of the chain (loads
// unconditional, the chain's steps selected: see sum_ahead).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gemv_kernel(const float* __restrict__ A, const float* __restrict__ v,
                float* out, int rows, int cols, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= rows) return;  // whole warp
  const float* a = A + ((size_t)b * rows + row) * cols;
  const float* vb = v + (size_t)b * cols;
  float acc = 0.f;
  if constexpr (VEC) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    const int n4 = cols >> 2;
    for (int j0 = lane; j0 < n4; j0 += 32 * GEMV_AHEAD) {
      float4 x[GEMV_AHEAD], w[GEMV_AHEAD];
#pragma unroll
      for (int k = 0; k < GEMV_AHEAD; ++k) {
        const int j = min(j0 + 32 * k, n4 - 1);
        x[k] = __ldg(a4 + j);
        w[k] = __ldg(v4 + j);
      }
#pragma unroll
      for (int k = 0; k < GEMV_AHEAD; ++k) {
        float t = fmaf(x[k].x, w[k].x, acc);
        t = fmaf(x[k].y, w[k].y, t);
        t = fmaf(x[k].z, w[k].z, t);
        t = fmaf(x[k].w, w[k].w, t);
        acc = j0 + 32 * k < n4 ? t : acc;
      }
    }
  } else {
    for (int j0 = lane; j0 < cols; j0 += 32 * GEMV_AHEAD) {
      float x[GEMV_AHEAD], w[GEMV_AHEAD];
#pragma unroll
      for (int k = 0; k < GEMV_AHEAD; ++k) {
        const int j = min(j0 + 32 * k, cols - 1);
        x[k] = __ldg(a + j);
        w[k] = __ldg(vb + j);
      }
#pragma unroll
      for (int k = 0; k < GEMV_AHEAD; ++k) {
        const float t = fmaf(x[k], w[k], acc);
        acc = j0 + 32 * k < cols ? t : acc;
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    float* o = out + (size_t)b * rows + row;
    *o = accumulate ? *o + acc : acc;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline void gemv(const float* A, const float* v, float* out, int rows,
                 int cols, int accumulate, int B, cudaStream_t s) {
  const dim3 grid((rows + 7) / 8, B);
  if (cols % 4 == 0 && aligned16(A) && aligned16(v))
    gemv_kernel<true><<<grid, THREADS, 0, s>>>(A, v, out, rows, cols,
                                               accumulate);
  else
    gemv_kernel<false><<<grid, THREADS, 0, s>>>(A, v, out, rows, cols,
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
    ax = sum_ahead(partial, b, nchunks, n, s) + sigma * xv[idx];
  } else {
    const int k = b * m + (s - n);
    ax = rowdot[k] - xv[idx] / rho[k];
  }
  r[idx] = bt[idx] - ax;
}

// The update, and the next step's b̃ from the new state (rhs_kernel's
// arithmetic), so that a step after the first needs no rhs launch.
__global__ void update_kernel(const float* __restrict__ xv,
                              float* __restrict__ x, float* __restrict__ y,
                              float* __restrict__ z,
                              const float* __restrict__ zl,
                              const float* __restrict__ zu,
                              const float* __restrict__ rho,
                              const float* __restrict__ p, float sigma,
                              float* __restrict__ bt, float alpha, int n,
                              int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    const int k = b * n + s;
    const float xn = alpha * xv[idx] + (1.0f - alpha) * x[k];
    x[k] = xn;
    bt[idx] = sigma * xn - p[k];
  } else {
    const int k = b * m + (s - n);
    const float rk = rho[k], yk = y[k], zk = z[k];
    const float zt = zk + (xv[idx] - yk) / rk;
    const float ztmp = alpha * zt + (1.0f - alpha) * zk;
    const float zn = fminf(fmaxf(ztmp + yk / rk, zl[k]), zu[k]);
    const float yn = yk + rk * (ztmp - zn);
    y[k] = yn;
    z[k] = zn;
    bt[idx] = zn - yn / rk;
  }
}

// dv[b, j] = Σ_c partial[b, c, j] + p[b, j], the dual residual's entries:
// a thread a column on CTAs of SUM_THREADS, so that the chunk sums run on
// many SMs.
__global__ void __launch_bounds__(SUM_THREADS)
    dual_kernel(const float* __restrict__ partial, int nchunks,
                const float* __restrict__ p, float* __restrict__ dv, int n) {
  const int b = blockIdx.y, j = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (j < n)
    dv[(size_t)b * n + j] =
        sum_ahead(partial, b, nchunks, n, j) + p[(size_t)b * n + j];
}

// Σ_i v_i² over i = tid, tid + UPD_THREADS, ... < len in order, one fmaf
// chain: v_i = a[i] − c[i] (c null: a[i]).  CHAIN_AHEAD loads of each
// array ahead of the chain (unconditional, the steps selected).
__device__ __forceinline__ float strided_sq(const float* a, const float* c,
                                            int len, int tid) {
  float s = 0.f;
  for (int i0 = tid; i0 < len; i0 += CHAIN_AHEAD * UPD_THREADS) {
    float u[CHAIN_AHEAD], w[CHAIN_AHEAD];
#pragma unroll
    for (int k = 0; k < CHAIN_AHEAD; ++k) {
      const int i = min(i0 + k * UPD_THREADS, len - 1);
      u[k] = a[i];
      w[k] = c ? c[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CHAIN_AHEAD; ++k) {
      const float v = c ? u[k] - w[k] : u[k];
      const float t = fmaf(v, v, s);
      s = i0 + k * UPD_THREADS < len ? t : s;
    }
  }
  return s;
}

// pr[b, i] = ‖A0x − z‖, dr[b, i] = ‖dv‖ = ‖Qx + p + A0ᵀy‖: one CTA of
// UPD_THREADS per instance, the first design's strided fmaf chains, warp
// sums and fold over the warps in order.
__global__ void __launch_bounds__(UPD_THREADS)
    norms_kernel(const float* __restrict__ rowdot,
                 const float* __restrict__ z, const float* __restrict__ dv,
                 float* __restrict__ pr, float* __restrict__ dr, int i,
                 int N, int n, int m) {
  __shared__ float red[2][32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float sp = strided_sq(rowdot + (size_t)b * m, z + (size_t)b * m, m, tid);
  float sd = strided_sq(dv + (size_t)b * n, nullptr, n, tid);
  sp = warp_sum(sp);
  sd = warp_sum(sd);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sp;
    red[1][tid >> 5] = sd;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < UPD_THREADS / 32; ++w) {
      a += red[0][w];
      c += red[1][w];
    }
    pr[(size_t)b * N + i] = sqrtf(a);
    dr[(size_t)b * N + i] = sqrtf(c);
  }
}

// The residual norms from the colpass of [x; y]: dv (B, n) is scratch.
inline void norms(const float* partial, const float* rowdot, int nchunks,
                  const float* z, const float* p, float* dv, float* pr,
                  float* dr, int i, int N, int n, int m, int B,
                  cudaStream_t s) {
  dual_kernel<<<dim3((n + SUM_THREADS - 1) / SUM_THREADS, B), SUM_THREADS, 0,
                s>>>(partial, nchunks, p, dv, n);
  norms_kernel<<<B, UPD_THREADS, 0, s>>>(rowdot, z, dv, pr, dr, i, N, n, m);
}

// ---- the condensed system ('direct', 'cg') ----

// The column partials of M·v (mv_kernel, MODE_MV) or of A0ᵀ(scale∘u −
// shift) alone (MODE_RHS), over chunks of kkt::ROWS rows from row 0 of Q
// (part_q, nq = ceil(n/32) chunks) and of A0 (part_a, na = ceil(m/32)):
//   part_q[b, c, j] = Σ_{i in chunk c of Q} Q[b, i, j]·v[b, i]
//   part_a[b, c, j] = Σ_{i in chunk c of A0} A0[b, i, j]·w[b, i]
// each a fmaf chain from 0 down the chunk's rows in order, with
// w = ρ∘(A0·v) (MODE_MV; A0·v as the KKT pass forms it) or scale∘u − shift.
enum { MODE_MV = 0, MODE_RHS = 1 };

// reverse: the items in reverse order (see cg_loop).  pad: no padding
// bytes (the CUDA graph's cache compares the struct's bytes).
struct MvArgs {
  const float *Q, *A0, *v;
  const float *scale, *u, *shift;
  float *part_q, *part_a;
  int n, m, B, nq, na, slab, reverse, pad;
};

// Shared memory of an A0 item, in floats: NBUF slab buffers (slab rows of
// lds, the row pitch 16 bytes past the groups so that a row-dot thread on
// each of eight rows reads its own bank quad), v's entries (ng groups of
// kkt::GROUP, zero past n), the chains' sums between slabs, the group sums
// of a slab (rows of ng + 1), the racc_w, and w (kkt::ROWS: a Q item's
// vector entries too), then the chunk's scale entries (kkt::ROWS), then
// the buffers' two mbarriers.
struct A0Lay {
  int ng, lds, slab;
  __host__ __device__ A0Lay(int n, int slab_rows)
      : ng((n + kkt::GROUP - 1) / kkt::GROUP),
        lds(ng * kkt::GROUP + 4),
        slab(slab_rows) {}
  __host__ __device__ int buf(int k) const { return k * slab * lds; }
  __host__ __device__ int us() const { return NBUF * slab * lds; }
  __host__ __device__ int acc() const {   // us: v, or u and shift (RHS)
    return us() + max(ng * kkt::GROUP, 2 * kkt::ROWS);
  }
  __host__ __device__ int gs() const { return acc() + ng * kkt::GROUP; }
  __host__ __device__ int racc() const { return gs() + slab * (ng + 1); }
  __host__ __device__ int wv() const { return racc() + slab * kkt::WAYS; }
  __host__ __device__ int bar() const {
    return (wv() + 2 * kkt::ROWS + 1) / 2 * 2;
  }
  __host__ __device__ int floats() const { return bar() + 4; }
};

// The most rows a slab whose A0 item fits A0_SMEM (at least one).
inline int a0_slab(int n) {
  for (int s = SLAB; s > 1; --s)
    if (sizeof(float) * A0Lay(n, s).floats() <= A0_SMEM) return s;
  return 1;
}

// Chunk c of Q's rows, instance b: part_q's chains, QB rows of loads in
// flight a thread (loads unconditional, the chains' steps selected).
template <bool VEC>
__device__ void q_item(const MvArgs& a, int b, int c, float* wq) {
  const int T = blockDim.x, tid = threadIdx.x, n = a.n;
  const int i0 = c * kkt::ROWS, rows = min(kkt::ROWS, n - i0);
  if (tid < rows) wq[tid] = __ldcg(a.v + (size_t)b * n + i0 + tid);
  __syncthreads();
  const float* Qc = a.Q + ((size_t)b * n + i0) * n;
  float* out = a.part_q + ((size_t)b * a.nq + c) * n;
  if constexpr (VEC) {
    const int n4 = n >> 2;
    for (int q = tid; q < n4; q += T) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = 0; r0 < rows; r0 += QB) {
        float4 x[QB];
#pragma unroll
        for (int k = 0; k < QB; ++k)
          x[k] = __ldg(reinterpret_cast<const float4*>(
                           Qc + (size_t)min(r0 + k, rows - 1) * n) + q);
#pragma unroll
        for (int k = 0; k < QB; ++k) {
          const float4 t = fma4(x[k], wq[r0 + k], acc);
          acc = r0 + k < rows ? t : acc;
        }
      }
      reinterpret_cast<float4*>(out)[q] = acc;
    }
  } else {
    for (int j = tid; j < n; j += T) {
      float acc = 0.f;
      for (int r0 = 0; r0 < rows; r0 += QB) {
        float x[QB];
#pragma unroll
        for (int k = 0; k < QB; ++k)
          x[k] = __ldg(Qc + (size_t)min(r0 + k, rows - 1) * n + j);
#pragma unroll
        for (int k = 0; k < QB; ++k) {
          const float t = fmaf(x[k], wq[r0 + k], acc);
          acc = r0 + k < rows ? t : acc;
        }
      }
      out[j] = acc;
    }
  }
}

// Chunk c of A0's rows, instance b: the rows come into shared memory a
// slab at a time (bulk copies, the next slab in flight while one is used);
// DOTS: each row's dot with v as kkt::colpass_kernel forms it (the
// butterfly of each group of 32 columns, then the groups g ≡ w (mod WAYS)
// in g order, then the racc_w in w order), w = scale∘dot; else
// w = scale∘u − shift.  Then part_a's chains run down the slab's rows.
template <bool VEC, bool DOTS>
__device__ void a0_item(const MvArgs& a, int b, int c, float* sm) {
  const A0Lay L(a.n, a.slab);
  const int T = blockDim.x, tid = threadIdx.x, n = a.n, m = a.m, ng = L.ng;
  const int i0 = c * kkt::ROWS, rows = min(kkt::ROWS, m - i0);
  const int nslab = (rows + L.slab - 1) / L.slab;
  float* us = sm + L.us();
  float* acc = sm + L.acc();
  float* gs = sm + L.gs();
  float* racc = sm + L.racc();
  float* wv = sm + L.wv();
  const float* Ab = a.A0 + ((size_t)b * m + i0) * n;
  float* out = a.part_a + ((size_t)b * a.na + c) * n;
  float* sc = wv + kkt::ROWS;
  const uint32_t bar0 = hop::smem_addr(sm + L.bar());   // a buffer's: + 8·k
  if (VEC && tid == 0) {
    hop::mbar_init(bar0, 1);
    hop::mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // slab s: with VEC one bulk copy (TMA) a row by one thread, completing on
  // its buffer's mbarrier; else 4-byte cp.async
  auto load_slab = [&](int s) {
    float* dst = sm + L.buf(s % NBUF);
    const int r0 = s * L.slab, sr = min(L.slab, rows - r0);
    if (VEC) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (s % NBUF);
        hop::mbar_expect_tx(bar, sr * n * sizeof(float));
        for (int r = 0; r < sr; ++r)
          kkt::bulk_load(dst + r * L.lds, Ab + (size_t)(r0 + r) * n,
                         n * sizeof(float), bar);
      }
    } else {
      for (int r = 0; r < sr; ++r)
        for (int j = tid; j < n; j += T)
          cp_async4(dst + r * L.lds + j, Ab + (size_t)(r0 + r) * n + j);
      cp_commit();
    }
  };
  // the chunk's scale entries and v's (DOTS) or u's and shift's, copied
  // while the first slab comes; the buffers' columns from n to the last
  // group's end zero (the pass's tile columns past n)
  if (tid < rows) {
    const size_t k = (size_t)b * m + i0 + tid;
    cp_async4(sc + tid, a.scale + k);
    if (!DOTS) {
      cp_async4(us + tid, a.u + k);
      cp_async4(us + kkt::ROWS + tid, a.shift + k);
    }
  }
  if (DOTS) {
    const float* vb = a.v + (size_t)b * n;
    if (VEC) {
      for (int k = tid; k < (n >> 2); k += T)
        cp_async16(us + 4 * k, vb + 4 * k);
    } else {
      for (int k = tid; k < n; k += T) cp_async4(us + k, vb + k);
    }
    for (int k = n + tid; k < ng * kkt::GROUP; k += T) us[k] = 0.f;
    const int pad = ng * kkt::GROUP - n;
    for (int k = tid; k < NBUF * L.slab * pad; k += T)
      sm[(k / pad) * L.lds + n + k % pad] = 0.f;   // rows of all buffers
  }
  cp_commit();
  load_slab(0);
  // the row dots' tasks: where eight threads a group cover the groups, a
  // thread keeps one group's v entries in registers for the whole item and
  // takes its rows of each slab (the eight rows of a group on eight bank
  // quads); else a task a (row, group)
  const bool fixed = DOTS && ng * 8 <= T;   // uniform
  const int gme = tid / 8, slice = tid % 8;
  float u[kkt::GROUP];
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) load_slab(s + 1);
    if (VEC) {
      if (s == 0) cp_wait<0>();
      hop::mbar_wait(bar0 + 8 * (s % NBUF), (s / NBUF) & 1);
    } else if (s + 1 < nslab) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* buf = sm + L.buf(s % NBUF);
    const int r0 = s * L.slab, sr = min(L.slab, rows - r0);
    if (DOTS) {
      auto load_u = [&](int g) {
#pragma unroll
        for (int e = 0; e < kkt::GROUP; e += 4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(us + g * kkt::GROUP + e);
          u[e] = v4.x;
          u[e + 1] = v4.y;
          u[e + 2] = v4.z;
          u[e + 3] = v4.w;
        }
      };
      if (fixed) {
        if (gme < ng) {
          if (s == 0) load_u(gme);
          for (int r = slice; r < sr; r += 8)
            gs[r * (ng + 1) + gme] =
                kkt::group_dot<float>(buf + r * L.lds, gme, u);
        }
      } else {
        for (int t = tid; t < sr * ng; t += T) {   // rows varying fastest
          const int r = t % sr, g = t / sr;
          load_u(g);
          gs[r * (ng + 1) + g] = kkt::group_dot<float>(buf + r * L.lds, g, u);
        }
      }
      __syncthreads();
      // the racc_w, a thread each; then a row's in w order, and w
      for (int t = tid; t < sr * kkt::WAYS; t += T) {
        const int r = t / kkt::WAYS, w = t % kkt::WAYS;
        float sum = 0.f;
        for (int g = w; g < ng; g += kkt::WAYS)
          sum = __fadd_rn(sum, gs[r * (ng + 1) + g]);
        racc[t] = sum;
      }
      __syncthreads();
      if (tid < sr) {
        float d = 0.f;
        for (int w = 0; w < kkt::WAYS; ++w)
          d = __fadd_rn(d, racc[tid * kkt::WAYS + w]);
        wv[tid] = __fmul_rn(sc[r0 + tid], d);
      }
    } else if (tid < sr) {
      float w = __fmul_rn(sc[r0 + tid], us[r0 + tid]);
      w -= us[kkt::ROWS + r0 + tid];
      wv[tid] = w;
    }
    __syncthreads();
    // the chains: a thread a column (16 bytes of columns with VEC)
    const bool last = s + 1 == nslab;
    if (VEC) {
      const int n4 = n >> 2;
      for (int q = tid; q < n4; q += T) {
        float4 t4 = s == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : reinterpret_cast<const float4*>(acc)[q];
        for (int r = 0; r < sr; ++r)
          t4 = fma4(reinterpret_cast<const float4*>(buf + r * L.lds)[q],
                    wv[r], t4);
        if (last)
          reinterpret_cast<float4*>(out)[q] = t4;
        else
          reinterpret_cast<float4*>(acc)[q] = t4;
      }
    } else {
      for (int j = tid; j < n; j += T) {
        float t = s == 0 ? 0.f : acc[j];
        for (int r = 0; r < sr; ++r) t = fmaf(buf[r * L.lds + j], wv[r], t);
        if (last)
          out[j] = t;
        else
          acc[j] = t;
      }
    }
    // this buffer's generic reads, before a bulk copy refills it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
}

template <int MODE>
__host__ __device__ inline int mv_items(const MvArgs& a) {
  return a.B * a.na + (MODE == MODE_MV ? a.B * a.nq : 0);
}

// A CTA an item: the A0 items first (the longer ones), then Q's (the other
// way round with reverse).
template <bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, MV_CTAS) mv_kernel(MvArgs a) {
  extern __shared__ __align__(16) float sm[];
  int k = a.reverse ? mv_items<MODE>(a) - 1 - blockIdx.x : blockIdx.x;
  if (k < a.B * a.na) {
    a0_item<VEC, MODE == MODE_MV>(a, k / a.na, k % a.na, sm);
  } else {
    k -= a.B * a.na;
    q_item<VEC>(a, k / a.nq, k % a.nq, sm + A0Lay(a.n, a.slab).wv());
  }
}

inline size_t mv_smem(const MvArgs& a) {
  return sizeof(float) * A0Lay(a.n, a.slab).floats();
}

inline bool mv_vec(const MvArgs& a) {
  return a.n % 4 == 0 && aligned16(a.Q) && aligned16(a.A0) &&
         aligned16(a.part_q) && aligned16(a.part_a) &&
         (a.v == nullptr || aligned16(a.v));
}

// A kernel's shared memory: `bytes` a CTA, and the SM's whole carveout
// for shared memory (mv_kernel: MV_CTAS CTAs an SM).  An error where
// `bytes` is beyond the device's limit (n above iadmm_stage2_max_n).
template <typename K>
inline cudaError_t smem_attrs(K kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();   // reported here, not by the next launch's check
    return e;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int MODE>
inline cudaError_t mv(const MvArgs& a, cudaStream_t s) {
  auto kernel = mv_vec(a) ? mv_kernel<true, MODE> : mv_kernel<false, MODE>;
  const cudaError_t e = smem_attrs(kernel, mv_smem(a));
  if (e != cudaSuccess) return e;
  kernel<<<mv_items<MODE>(a), THREADS, mv_smem(a), s>>>(a);
  return cudaSuccess;
}

// b = σx − p + A0ᵀ(ρz − y) from the A0 partials.
__global__ void cond_rhs_kernel(const float* __restrict__ part_a, int na,
                                const float* __restrict__ x,
                                const float* __restrict__ p, float sigma,
                                float* __restrict__ bvec, int n, int B) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n, j = idx % n;
  bvec[idx] = (sigma * x[idx] - p[idx]) + sum_ahead(part_a, b, na, n, j);
}

// out = b − M·v from mv's partials: M·v = (Qv + σv) + A0ᵀ(ρ∘A0v).
__global__ void cond_residual_kernel(const float* __restrict__ part_q,
                                     int nq, const float* __restrict__ part_a,
                                     int na, const float* __restrict__ v,
                                     const float* __restrict__ bvec,
                                     float sigma, float* __restrict__ out,
                                     int n, int B) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n) return;
  const int b = idx / n, j = idx % n;
  float mv = sum_ahead(part_q, b, nq, n, j) + sigma * v[idx];
  mv += sum_ahead(part_a, b, na, n, j);
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

// The CG iteration after M·p: its vectors, scalars and scratch.  wsum
// (B, nblk·CG_THREADS/32, 2): a warp's sums of p·Ap and r·r; ap (B, n).
struct CgArgs {
  const float *part_q, *part_a, *diag;
  float *pv, *r, *xt, *ap, *wsum, *scal;
  int* iters;
  int n, nq, na, B;
  float sigma, tol;

  __host__ __device__ int nblk() const {
    return (n + CG_THREADS - 1) / CG_THREADS;
  }
  __host__ __device__ int warps() const {
    return nblk() * (CG_THREADS / 32);
  }
};

// Ap = (Qp + σp) + A0ᵀ(ρ∘A0p), a column a thread, instance blockIdx.y,
// and each warp's sums of p·Ap and r·r (cg_ap's products and warp_sum;
// columns past n give 0 up to the last CG_THREADS-column block).
__global__ void __launch_bounds__(SUM_THREADS) ap_kernel(CgArgs a) {
  const int b = blockIdx.y, n = a.n;
  const int j = blockIdx.x * SUM_THREADS + threadIdx.x;
  float d_pap = 0.f, d_rr = 0.f;
  if (j < n) {
    const size_t k = (size_t)b * n + j;
    const float pk = __ldg(a.pv + k);
    float v = sum_ahead(a.part_q, b, a.nq, n, j) + a.sigma * pk;
    v += sum_ahead(a.part_a, b, a.na, n, j);
    a.ap[k] = v;
    const float rk = __ldg(a.r + k);
    d_pap = pk * v;
    d_rr = rk * rk;
  }
  d_pap = warp_sum(d_pap);
  d_rr = warp_sum(d_rr);
  if ((threadIdx.x & 31) == 0) {
    float* o = a.wsum + ((size_t)b * a.warps() + (j >> 5)) * 2;
    o[0] = d_pap;
    o[1] = d_rr;
  }
}

// update_kernel_cg's shared memory, in floats: the warp sums of its chain,
// three broadcast scalars, the blocks' sums of pᵀAp and rᵀr (two a
// CG_THREADS-column block), then p, the new r and d (n each).
__host__ __device__ inline int update_floats(int n) {
  return 36 + 2 * ((n + CG_THREADS - 1) / CG_THREADS) + 3 * n;
}

// The rest of a CG iteration (cg_update's arithmetic and orders), a CTA
// an instance: pᵀAp and rᵀr, each block's warp sums in warp order from 0
// (a thread a block), then the blocks in order; the mask and α; xt += αp,
// r −= αAp and rz' = rᵀ(r/d), CHAIN_AHEAD elements of loads ahead of each
// thread's strided chain; the fold of the warps in order; β;
// p = r/d + βp.
__global__ void __launch_bounds__(UPD_THREADS) update_kernel_cg(CgArgs a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, n = a.n;
  float* red = sm;
  float* bc = red + 32;
  float* blk = bc + 4;
  float* ps = blk + 2 * a.nblk();
  float* rs = ps + n;
  float* ds = rs + n;
  const float* ws = a.wsum + (size_t)b * a.warps() * 2;
  for (int c = tid; c < a.nblk(); c += UPD_THREADS) {
    float sp = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < CG_THREADS / 32; ++w) {
      const int k = c * (CG_THREADS / 32) + w;
      sp += __ldg(ws + 2 * k);
      sq += __ldg(ws + 2 * k + 1);
    }
    blk[2 * c] = sp;
    blk[2 * c + 1] = sq;
  }
  __syncthreads();
  if (tid == 0) {
    float denom = 0.f, rr = 0.f;
    for (int c = 0; c < a.nblk(); ++c) {
      denom += blk[2 * c];
      rr += blk[2 * c + 1];
    }
    const float rz = __ldcg(a.scal + 2 * b), bnorm = __ldcg(a.scal + 2 * b + 1);
    const bool active = (sqrtf(rr) / bnorm > a.tol) && (denom > 0.f);
    bc[0] = active ? rz / (denom == 0.f ? 1.f : denom) : 0.f;
    bc[1] = active ? 1.f : 0.f;
  }
  __syncthreads();
  const float alpha = bc[0];
  const bool active = bc[1] != 0.f;
  float s = 0.f;
  for (int j0 = tid; j0 < n; j0 += CHAIN_AHEAD * UPD_THREADS) {
    float xv[CHAIN_AHEAD], pv[CHAIN_AHEAD], rv[CHAIN_AHEAD],
        av[CHAIN_AHEAD], dv[CHAIN_AHEAD];
#pragma unroll
    for (int e = 0; e < CHAIN_AHEAD; ++e) {
      const size_t k = (size_t)b * n + min(j0 + e * UPD_THREADS, n - 1);
      xv[e] = __ldg(a.xt + k);
      pv[e] = __ldg(a.pv + k);
      rv[e] = __ldg(a.r + k);
      av[e] = __ldg(a.ap + k);
      dv[e] = a.diag[k];
    }
#pragma unroll
    for (int e = 0; e < CHAIN_AHEAD; ++e) {
      const int j = j0 + e * UPD_THREADS;
      const float xn = xv[e] + alpha * pv[e];
      const float rn = rv[e] - alpha * av[e];
      const float t = fmaf(rn, rn / dv[e], s);
      if (j < n) {
        const size_t k = (size_t)b * n + j;
        a.xt[k] = xn;
        a.r[k] = rn;
        ps[j] = pv[e];
        rs[j] = rn;
        ds[j] = dv[e];
        s = t;
      }
    }
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) red[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float rz_new = 0.f;
    for (int w = 0; w < UPD_THREADS / 32; ++w) rz_new += red[w];
    const float rz = __ldcg(a.scal + 2 * b);
    bc[2] = active ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
    a.scal[2 * b] = active ? rz_new : rz;
    a.iters[b] += active ? 1 : 0;
  }
  __syncthreads();
  const float beta = bc[2];
  for (int j = tid; j < n; j += UPD_THREADS)
    a.pv[(size_t)b * n + j] = rs[j] / ds[j] + beta * ps[j];
}

// One CG iteration after mv: two launches (update_kernel_cg's shared
// memory set by cg_loop).
inline void ap_update(const CgArgs& a, cudaStream_t s) {
  ap_kernel<<<dim3((a.nblk() * CG_THREADS + SUM_THREADS - 1) / SUM_THREADS,
                   a.B),
              SUM_THREADS, 0, s>>>(a);
  update_kernel_cg<<<a.B, UPD_THREADS, sizeof(float) * update_floats(a.n),
                     s>>>(a);
}

// The CG loop as a CUDA graph: captured on a stream of its own for one
// argument set (every pointer, size and scalar), replayed while the
// arguments stay the same.  One entry and no lock: a call with another
// argument set (new scratch, another batch) captures and instantiates the
// graph again, at its first step (0.9–1.5 ms a call at B = 8, n = m = 1000
// on an H100, chip_smoke.py --time-rows), and calls from several host
// threads at once are not supported.
struct LoopGraph {
  unsigned char key[sizeof(MvArgs) + sizeof(CgArgs) + sizeof(int)];
  cudaGraphExec_t exec = nullptr;
  cudaStream_t capture = nullptr;
};
LoopGraph graph_cache;

// The `iters` CG iterations of a step.  Odd iterations take the M·v's
// items in reverse order, so that the rows read last, still in L2, are read
// first (Q and A0 of B = 8 instances are 64 MB, beyond the 50 MB L2); each
// item's arithmetic is the same either way.
int cg_loop(const MvArgs& mva, const CgArgs& cga, int iters, cudaStream_t s) {
  cudaError_t e = smem_attrs(update_kernel_cg,
                             sizeof(float) * update_floats(cga.n));
  if (e != cudaSuccess) return static_cast<int>(e);
  LoopGraph& g = graph_cache;
  unsigned char key[sizeof(g.key)];
  std::memcpy(key, &mva, sizeof(MvArgs));
  std::memcpy(key + sizeof(MvArgs), &cga, sizeof(CgArgs));
  std::memcpy(key + sizeof(MvArgs) + sizeof(CgArgs), &iters, sizeof(int));
  if (!g.exec || std::memcmp(key, g.key, sizeof(key)) != 0) {
    if (!g.capture) {
      e = cudaStreamCreateWithFlags(&g.capture, cudaStreamNonBlocking);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    e = cudaStreamBeginCapture(g.capture, cudaStreamCaptureModeRelaxed);
    if (e != cudaSuccess) return static_cast<int>(e);
    MvArgs ma = mva;
    cudaError_t first = cudaSuccess;
    for (int k = 0; k < iters && first == cudaSuccess; ++k) {
      ma.reverse = k & 1;
      first = mv<MODE_MV>(ma, g.capture);
      ap_update(cga, g.capture);
    }
    cudaGraph_t graph = nullptr;
    e = cudaStreamEndCapture(g.capture, &graph);
    if (first != cudaSuccess) e = first;
    if (g.exec) cudaGraphExecDestroy(g.exec);
    g.exec = nullptr;
    if (e == cudaSuccess) e = cudaGraphInstantiate(&g.exec, graph, 0);
    if (graph) cudaGraphDestroy(graph);
    if (e != cudaSuccess) {
      g.exec = nullptr;
      return static_cast<int>(e);
    }
    std::memcpy(g.key, key, sizeof(key));
  }
  return static_cast<int>(cudaGraphLaunch(g.exec, s));
}

// The operands and scratch of a condensed step, in the C entry points'
// argument order.
struct Condensed {
  const void* Q;
  const float *A0, *p, *zl, *zu, *rho;
  float *x, *y, *z, *xt, *bvec, *r;
  float *part_q, *part_a, *rowdot;
  int B, n, m;
  float sigma, alpha;
  cudaStream_t s;

  int eblocks(int len) const { return (B * len + 255) / 256; }
  int sblocks(int len) const {
    return (B * len + SUM_THREADS - 1) / SUM_THREADS;
  }
  int nq() const { return (n + kkt::ROWS - 1) / kkt::ROWS; }
  int na() const { return (m + kkt::ROWS - 1) / kkt::ROWS; }

  MvArgs mv_args(const float* v) const {
    return MvArgs{static_cast<const float*>(Q), A0, v, rho, z, y, part_q,
                  part_a, n, m, B, nq(), na(), a0_slab(n), 0, 0};
  }

  // bvec = σx − p + A0ᵀ(ρz − y)
  int rhs() const {
    const cudaError_t e = mv<MODE_RHS>(mv_args(nullptr), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    cond_rhs_kernel<<<sblocks(n), SUM_THREADS, 0, s>>>(part_a, na(), x, p,
                                                       sigma, bvec, n, B);
    return 0;
  }

  // r = bvec − M·v
  int residual(const float* v) const {
    const cudaError_t e = mv<MODE_MV>(mv_args(v), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    cond_residual_kernel<<<sblocks(n), SUM_THREADS, 0, s>>>(
        part_q, nq(), part_a, na(), v, bvec, sigma, r, n, B);
    return 0;
  }

  // ν from xt, the update, and the step's residual norms.
  void finish(int i, int N, float* pr, float* dr) const {
    gemv(A0, xt, rowdot, m, n, 0, B, s);
    cond_update_kernel<<<eblocks(n + m), 256, 0, s>>>(
        xt, rowdot, x, y, z, zl, zu, rho, alpha, n, m, B);
    kkt::colpass<float, false>(Q, A0, x, n, y, m, part_q, rowdot, n, m, B,
                               s);
    norms(part_q, rowdot, kkt::n_chunks(n, m), z, p, r, pr, dr, i, N, n, m,
          B, s);
  }
};

}  // namespace

extern "C" {

// Polish step i of N, solver 'kkt'.  All float32.  Q (B,n,n), A0 (B,m,n),
// Ainv (B,n+m,n+m), p (B,n), zl, zu, rho (B,m).  x (B,n), y, z (B,m) are
// updated in place; xv (B,n+m) receives the solve.  bt, r (B,n+m),
// mv_partial (B, ceil((n+m)/32), n) and rowdot (B,m) are scratch; steps
// 0 .. N − 1 run in order on the same bt (step i > 0 reads the b̃ that
// step i − 1 left there).  pr, dr: (B, N).
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

  // b̃: step i > 0 finds it written by step i − 1's update
  if (i == 0)
    rhs_kernel<<<eblocks, 256, 0, s>>>(xf, yf, zf, pf, rf, sigma, btf, n, m,
                                       B);
  gemv(A, btf, xvf, S, S, 0, B, s);
  for (int k = 0; k < refine; ++k) {
    kkt::colpass<float, false>(Q, A0, xvf, S, xvf + n, S, part, rd, n, m, B,
                               s);
    refine_kernel<<<(B * S + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                    s>>>(part, rd, nch, xvf, btf, rf, sigma, res, n, m, B);
    gemv(A, res, xvf, S, S, 1, B, s);
  }
  update_kernel<<<eblocks, 256, 0, s>>>(
      xvf, xf, yf, zf, static_cast<const float*>(zl),
      static_cast<const float*>(zu), rf, pf, sigma, btf, alpha, n, m, B);
  kkt::colpass<float, false>(Q, A0, xf, n, yf, m, part, rd, n, m, B, s);
  norms(part, rd, nch, zf, pf, res, static_cast<float*>(pr),
        static_cast<float*>(dr), i, N, n, m, B, s);
  return static_cast<int>(cudaGetLastError());
}

// Polish step i of N, solver 'direct'.  All float32.  Q (B,n,n), A0 (B,m,n),
// P = (M⁻¹)ᵀ (B,n,n), p (B,n), zl, zu, rho (B,m).  x, xt (B,n), y, z (B,m)
// are updated in place.  Scratch: bvec, r (B,n), part_q (B,
// ceil((n+m)/32), n), part_a (B, ceil(m/32), n), rowdot (B,m).  pr, dr:
// (B, N).
int iadmm_stage2_direct_step(int i, int N, int refine, const void* Q,
                             const void* A0, const void* P, const void* p,
                             const void* zl, const void* zu, const void* rho,
                             void* x, void* y, void* z, void* xt, void* bvec,
                             void* r, void* part_q, void* part_a,
                             void* rowdot, void* pr, void* dr, int B, int n,
                             int m, float sigma, float alpha, void* stream) {
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
                    static_cast<float*>(part_q),
                    static_cast<float*>(part_a),
                    static_cast<float*>(rowdot),
                    B, n, m, sigma, alpha,
                    static_cast<cudaStream_t>(stream)};
  const float* Pf = static_cast<const float*>(P);
  if (const int e = c.rhs()) return e;
  gemv(Pf, c.bvec, c.xt, n, n, 0, B, c.s);
  for (int k = 0; k < refine; ++k) {
    if (const int e = c.residual(c.xt)) return e;
    gemv(Pf, c.r, c.xt, n, n, 1, B, c.s);
  }
  c.finish(i, N, static_cast<float*>(pr), static_cast<float*>(dr));
  return static_cast<int>(cudaGetLastError());
}

// Polish step i of N, solver 'cg'.  As iadmm_stage2_direct_step, with the
// Jacobi diagonal diag (B,n) in place of P, and further scratch: pv, ap
// (B,n), wsum (B, ceil(n/256)·8, 2), scal (B,2).  xt carries the warm start
// across steps; iters (B,) int32 counts the unmasked CG iterations.
int iadmm_stage2_cg_step(int i, int N, int cg_iters, const void* Q,
                         const void* A0, const void* diag, const void* p,
                         const void* zl, const void* zu, const void* rho,
                         void* x, void* y, void* z, void* xt, void* bvec,
                         void* r, void* part_q, void* part_a, void* rowdot,
                         void* pv, void* ap, void* wsum, void* scal,
                         void* iters, void* pr, void* dr, int B,
                         int n, int m, float sigma, float tol, float alpha,
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
                    static_cast<float*>(part_q),
                    static_cast<float*>(part_a),
                    static_cast<float*>(rowdot),
                    B, n, m, sigma, alpha,
                    static_cast<cudaStream_t>(stream)};
  const float* d = static_cast<const float*>(diag);
  float* pvf = static_cast<float*>(pv);
  float* sc = static_cast<float*>(scal);
  if (const int e = c.rhs()) return e;
  if (const int e = c.residual(c.xt)) return e;
  cg_init_kernel<<<B, 256, 0, c.s>>>(c.r, c.bvec, d, pvf, sc, n);
  const CgArgs cga{c.part_q, c.part_a, d, pvf, c.r, c.xt,
                   static_cast<float*>(ap), static_cast<float*>(wsum), sc,
                   static_cast<int*>(iters), n, c.nq(), c.na(), B, sigma,
                   tol};
  if (const int e = cg_loop(c.mv_args(pvf), cga, cg_iters, c.s)) return e;
  c.finish(i, N, static_cast<float*>(pr), static_cast<float*>(dr));
  return static_cast<int>(cudaGetLastError());
}

// The largest n that 'direct' and 'cg' take on the current device: an A0
// item of mv_kernel at one-row slabs and the CG update within the
// device's shared memory a CTA (the opt-in limit).
int iadmm_stage2_max_n() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  auto fits = [&](int n) {
    return sizeof(float) * A0Lay(n, a0_slab(n)).floats() <= (size_t)optin &&
           sizeof(float) * update_floats(n) <= (size_t)optin;
  };
  int lo = 0, hi = optin;   // fits(lo); n = optin does not fit
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    (fits(mid) ? lo : hi) = mid;
  }
  return lo;
}

}  // extern "C"

