// Modified Ruiz equilibration of a batch of QPs for Hopper (sm_90a): every
// sweep of scaling/ruiz.py::ruiz_scale in one launch, float32.
//
// Replaces no TPU kernel: the JAX package leaves Ruiz to XLA
// (iadmm_tpu/scaling/ruiz.py, 10 sweeps of elementwise ops fused by the
// compiler).  It was added because on the H100 the eager sweeps (about 28
// PyTorch ops a sweep: |Q| and |A0| materialised twice, Q and A0 rewritten
// three times) took ~10–14 ms of a serving solve, about 0.7 GB of traffic
// a sweep and several hundred launches, most of them on (B, n + m) vectors
// that take microseconds on the card and as long again on the host.
//
// What bounds it: bytes.  Q and A0 must be read once and written once (128
// MB at B = 8, n = m = 1000: 0.038 ms at 3.35 TB/s; 192 MB at m = 2n).  A
// sweep's work is a few float32 products and maxima an element.
//
// Design:
// - the factors stay vectors (d, e, cost) and each sweep t needs, from one
//   read of Q and A0 under the current factors, three results: the column
//   maxima of |D Q D|, the column maxima of |E A0 D|, the row maxima of
//   |E A0 D|.  The cost norm needs the column maxima of Q after dt and
//   before the cost factor c_t; those of Q after c_t are c_t times them
//   (a product by c_t > 0 rounds monotonically, so the maximum of the
//   rounded products is the rounded product of the maximum, bit for bit).
//   So a sweep is one pass over the data, and the cost factor is applied
//   to each element lazily, at the start of the next pass.
// - the data stay on chip across the sweeps: an instance's rows are spread
//   over the shared memory of a slot of CTAs (a CTA a band of rows of the
//   stacked [Q; A0], ~46 rows at n = 1000), read from HBM once, rescaled in
//   place every sweep, written once.  One persistent cooperative launch of
//   one CTA an SM runs as many instances at a time as fit (3 at the
//   flagship's 8 MB an instance, 2 at Random_QP's 12 MB) and walks the
//   batch in rounds; the CTAs of a slot meet at a barrier in device memory
//   after each pass.  An instance too large for every SM's shared memory
//   together keeps its rows in the output buffers instead (read and
//   rewritten every pass).
// - cross-CTA maxima: each warp keeps its columns' maxima in registers, the
//   CTA folds them with shared-memory atomicMax, and each CTA folds its
//   columns into the slot's (pass, column) slots in device memory with one
//   atomicMax on the bit pattern (non-negative floats order as their bits):
//   exact, so the result does not depend on the order of the atomics.  Row
//   maxima stay inside the CTA that owns the row.
// - every CTA of a slot forms the column factors dt and the cost factor
//   from those maxima itself, in the same order, so the CTAs agree bit for
//   bit without another barrier; each owns the row factors, e, zl and zu of
//   its rows and a slice of d; every CTA keeps p.
// - bits: every element is computed in the eager order, (dt_i·v)·dt_j and
//   c·v for Q, (et_i·v)·dt_j for A0, with IEEE products, __fsqrt_rn and
//   __fdiv_rn (1/sqrt as torch's reciprocal of sqrt), the clamp to [1e-4,
//   1e4] with clamped-to-floor entries reset to 1.  The one sum, the mean
//   of the n column maxima, is taken by one warp in the order of PyTorch's
//   CUDA mean over a contiguous last dimension of length n ≥ 128 with rows
//   16-byte aligned (vectors of 4, four accumulators a thread, a block of W
//   threads folded in halves, then shfl_down; W from the batch size and n as
//   PyTorch's reduction chooses it), times float(B)/float(B·n).  Where that
//   holds on the PyTorch at hand, every output is the eager function's,
//   bit for bit; kernels/ruiz_kernel.py::ruiz_plain repeats this order in
//   PyTorch for every shape.  NaN entries drop out of the maxima (fmaxf),
//   where PyTorch's amax would keep them.
// Two calls give the same bits: every maximum is exact and every sum has a
// fixed order.

#include <cuda_runtime.h>

#include <algorithm>

namespace iadmm {
namespace ruiz {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 8;             // chunks a lane holds in a column block
constexpr int MAX_SLOTS = 1024;   // barrier counters at the workspace's head
constexpr int RED = 36;           // floats of the block reduction's scratch
constexpr float MIN_SCALING = 1e-4f;
constexpr float MAX_SCALING = 1e4f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* Q;    // (B, n, n)
  const float* p;    // (B, n)
  const float* A0;   // (B, m, n)
  const float* zl;   // (B, m)
  const float* zu;
  float* Qo;
  float* po;
  float* Ao;
  float* zlo;
  float* zuo;
  float* d;          // (B, n)
  float* e;          // (B, m)
  float* cost;       // (B,)
  unsigned* ctr;     // (MAX_SLOTS,) a barrier counter a slot
  unsigned* cmax;    // (B, iters + 1, 2, n): pass k's column maxima, Q then A0
  int B, n, m, iters;
  int slots, ctas, R, resident, ld, W;
  float mean_factor;
};

// ---- small helpers ----------------------------------------------------------

// _limit_scaling: clamp to [MIN, MAX] (NaN kept, as torch.clamp), entries
// clamped to the floor reset to 1.
__device__ __forceinline__ float limit(float v) {
  if (v != v) return v;
  const float c = fminf(fmaxf(v, MIN_SCALING), MAX_SCALING);
  return c == MIN_SCALING ? 1.0f : c;
}

// torch.maximum: NaN if either is.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// 1.0 / torch.sqrt(v): the reciprocal of the IEEE square root.
__device__ __forceinline__ float inv_sqrt(float v) {
  return __fdiv_rn(1.0f, __fsqrt_rn(v));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The CTAs of a slot: every write before it is visible to every CTA of the
// slot after it.  A wait of ~10 s traps (a fault, not a hang).
__device__ __forceinline__ void slot_barrier(unsigned* ctr, unsigned target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(ctr, 1u);
    const long long t0 = clock64();
    while (ld_acquire(ctr) < target)
      if (clock64() - t0 > (1LL << 34)) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < WARPS ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      w = fmaxf(w, __shfl_xor_sync(FULL, w, o));
    if (threadIdx.x == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

// Σ v[0..n) in the order of PyTorch's CUDA mean over a contiguous row of n
// floats, 16-byte aligned (ReduceConfig's "vectorize along input"): virtual
// thread x < W adds the vectors x, x + W, ... into four accumulators, one a
// vector lane (the n % 4 tail to thread x's first), combines them in lane
// order; the W threads fold in halves down to 32, then shfl_down from 16.
// One warp calls it; every lane gets the sum.
__device__ float torch_order_sum(const float* v, int n, int W) {
  const int lane = threadIdx.x & 31;
  const int per = W >> 5;   // virtual threads a lane, 1..16
  const int nv = n >> 2, tail = n & 3;
  float val[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    val[k] = 0.f;
    if (k < per) {
      const int x = lane + 32 * k;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int q = x; q < nv; q += W) {
        const float4 t = *reinterpret_cast<const float4*>(v + 4 * q);
        a0 = __fadd_rn(a0, t.x);
        a1 = __fadd_rn(a1, t.y);
        a2 = __fadd_rn(a2, t.z);
        a3 = __fadd_rn(a3, t.w);
      }
      if (x < tail) a0 = __fadd_rn(a0, v[4 * nv + x]);
      val[k] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
    }
  }
#pragma unroll
  for (int j = 8; j >= 1; j >>= 1)
    if (2 * j <= per) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < j) val[k] = __fadd_rn(val[k], val[k + j]);
    }
  float s = val[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(FULL, s, o));
  return __shfl_sync(FULL, s, 0);
}

template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// ---- one CTA's view of its instance -----------------------------------------

enum Where { IN = 0, OUT = 1, SMEM = 2 };

// Shared memory (floats): dt, p, the column maxima of Q rows and of A0 rows
// (as bits), each ld4; then a row's factor, its maximum, e, zl, zu, each R4;
// the reduction scratch; the rows (resident only), ld apart.
struct Lay {
  int dt, p, cq, ca, fac, rmax, e, zl, zu, red, rows, total;
  __host__ __device__ Lay(int n, int R, bool resident) {
    const int ld4 = (n + 3) / 4 * 4, R4 = (R + 3) / 4 * 4;
    dt = 0;
    p = dt + ld4;
    cq = p + ld4;
    ca = cq + ld4;
    fac = ca + ld4;
    rmax = fac + R4;
    e = rmax + R4;
    zl = e + R4;
    zu = zl + R4;
    red = zu + R4;
    rows = red + (RED + 3) / 4 * 4;
    total = rows + (resident ? R * ld4 : 0);
  }
};

struct Inst {
  const float* Q;
  const float* A0;
  float* Qo;
  float* Ao;
  float* rows;   // shared memory
  int n, ld, r0, r1;
  __device__ const float* src(Where w, int r) const {
    if (w == SMEM) return rows + (size_t)(r - r0) * ld;
    if (w == IN) return r < n ? Q + (size_t)r * n : A0 + (size_t)(r - n) * n;
    return r < n ? Qo + (size_t)r * n : Ao + (size_t)(r - n) * n;
  }
  __device__ float* dst(Where w, int r) const {
    return const_cast<float*>(src(w, r));
  }
};

// Warp-held column maxima into the CTA's (shared-memory atomicMax).
template <int V>
__device__ __forceinline__ void fold_cols(unsigned* cm_s, int cb, int nch,
                                          float (&cm)[KC][V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int ch = cb + lane + 32 * k;
    if (ch < nch) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        atomicMax(cm_s + ch * V + i, __float_as_uint(cm[k][i]));
        cm[k][i] = 0.f;
      }
    }
  }
}

// One pass over the CTA's rows [r0, r1): Q rows v ← c·v (capply), then
// (fac_i·v)·dt_j; A0 rows (fac_i·v)·dt_j; each stored back (src → dst) and
// its |v| folded into the column maxima (cq_s for Q rows, ca_s for A0
// rows) and, for A0 rows, the row's maximum (rmax_s).  A warp takes rows
// r0 + warp, r0 + warp + WARPS, ...; a lane the chunks of V columns
// cb + lane + 32k of each column block of 32·KC chunks.
template <int V>
__device__ void sweep_pass(const Inst& I, Where from, Where to, bool capply,
                           float c, const float* dt_s, const float* fac_s,
                           float* rmax_s, unsigned* cq_s, unsigned* ca_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = I.n, nch = n / V;
  for (int cb = 0; cb < nch; cb += 32 * KC) {
    float dtr[KC][V], cm[KC][V];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int ch = cb + lane + 32 * k;
      if (ch < nch) {
        ldv<V>(dt_s + ch * V, dtr[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dtr[k][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) cm[k][i] = 0.f;
    }
    int r = I.r0 + warp;
    bool any = false;
    for (; r < I.r1 && r < n; r += WARPS) {   // Q rows
      any = true;
      const float fi = fac_s[r - I.r0];
      const float* s = I.src(from, r);
      float* t = I.dst(to, r);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int ch = cb + lane + 32 * k;
        if (ch < nch) {
          float v[V];
          ldv<V>(s + ch * V, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            float u = capply ? __fmul_rn(c, v[i]) : v[i];
            u = __fmul_rn(__fmul_rn(fi, u), dtr[k][i]);
            v[i] = u;
            cm[k][i] = fmaxf(cm[k][i], fabsf(u));
          }
          stv<V>(t + ch * V, v);
        }
      }
    }
    if (any) fold_cols<V>(cq_s, cb, nch, cm);
    any = false;
    for (; r < I.r1; r += WARPS) {   // A0 rows
      any = true;
      const float fi = fac_s[r - I.r0];
      const float* s = I.src(from, r);
      float* t = I.dst(to, r);
      float rm = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int ch = cb + lane + 32 * k;
        if (ch < nch) {
          float v[V];
          ldv<V>(s + ch * V, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float u = __fmul_rn(__fmul_rn(fi, v[i]), dtr[k][i]);
            v[i] = u;
            cm[k][i] = fmaxf(cm[k][i], fabsf(u));
            rm = fmaxf(rm, fabsf(u));
          }
          stv<V>(t + ch * V, v);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rm = fmaxf(rm, __shfl_xor_sync(FULL, rm, o));
      if (lane == 0)
        rmax_s[r - I.r0] = cb == 0 ? rm : fmaxf(rmax_s[r - I.r0], rm);
    }
    if (any) fold_cols<V>(ca_s, cb, nch, cm);
  }
}

// The last pass: Q rows v ← c·v (capply), every row from → to (A0 rows only
// where they move).
template <int V>
__device__ void final_pass(const Inst& I, Where from, Where to, bool capply,
                           float c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = I.n / V;
  for (int r = I.r0 + warp; r < I.r1; r += WARPS) {
    const bool q = r < I.n;
    if (!q && from == to) continue;
    if (q && !capply && from == to) continue;
    const float* s = I.src(from, r);
    float* t = I.dst(to, r);
    for (int ch = lane; ch < nch; ch += 32) {
      float v[V];
      ldv<V>(s + ch * V, v);
      if (q && capply) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = __fmul_rn(c, v[i]);
      }
      stv<V>(t + ch * V, v);
    }
  }
}

// Fold the CTA's column maxima into the slot's, pass k, in device memory.
__device__ __forceinline__ void fold_global(const Args& a, int b, int k,
                                            const unsigned* cq_s,
                                            const unsigned* ca_s, bool has_q,
                                            bool has_a) {
  unsigned* g = a.cmax + ((size_t)b * (a.iters + 1) + k) * 2 * a.n;
  for (int j = threadIdx.x; j < a.n; j += THREADS) {
    if (has_q) atomicMax(g + j, cq_s[j]);
    if (has_a) atomicMax(g + a.n + j, ca_s[j]);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1) ruiz_kernel(Args a) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int cta = blockIdx.x;
  const int slot = cta / a.ctas, j = cta % a.ctas;
  if (slot >= a.slots) return;
  const int n = a.n, m = a.m, rows = n + m;
  const Lay L(n, a.R, a.resident);
  float* dt_s = sm + L.dt;
  float* p_s = sm + L.p;
  unsigned* cq_s = reinterpret_cast<unsigned*>(sm + L.cq);
  unsigned* ca_s = reinterpret_cast<unsigned*>(sm + L.ca);
  float* fac_s = sm + L.fac;
  float* rmax_s = sm + L.rmax;
  float* e_s = sm + L.e;
  float* zl_s = sm + L.zl;
  float* zu_s = sm + L.zu;
  float* red = sm + L.red;
  float* pm_s = red + 33;   // limit(max |p|) after the last dt
  float* c_s = red + 34;    // the cost factor of the last pass
  const int r0 = min(j * a.R, rows), r1 = min(r0 + a.R, rows);
  const int dc = (n + a.ctas - 1) / a.ctas;   // this CTA's slice of d
  const int d0 = min(j * dc, n), d1 = min(d0 + dc, n);
  const bool has_q = r0 < min(r1, n), has_a = r1 > max(r0, n);
  const Where store = a.resident ? SMEM : OUT;
  unsigned* ctr = a.ctr + slot;
  unsigned barriers = 0;

  for (int b = slot; b < a.B; b += a.slots) {
    const Inst I{a.Q + (size_t)b * n * n, a.A0 + (size_t)b * m * n,
                 a.Qo + (size_t)b * n * n, a.Ao + (size_t)b * m * n,
                 sm + L.rows, n, (n + 3) / 4 * 4, r0, r1};
    const float* pb = a.p + (size_t)b * n;
    float* db = a.d + (size_t)b * n;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      p_s[i] = pb[i];
      dt_s[i] = 1.f;
      cq_s[i] = 0u;
      ca_s[i] = 0u;
    }
    for (int i = threadIdx.x; i < r1 - r0; i += THREADS) {
      fac_s[i] = 1.f;
      const int r = r0 + i - n;
      if (r >= 0) {
        e_s[i] = 1.f;
        zl_s[i] = a.zl[(size_t)b * m + r];
        zu_s[i] = a.zu[(size_t)b * m + r];
      }
    }
    __syncthreads();
    // pass 0: the maxima of the data as given (factors 1: exact), copied
    // where the sweeps will read it
    sweep_pass<V>(I, IN, store, false, 1.f, dt_s, fac_s, rmax_s, cq_s, ca_s);
    __syncthreads();
    fold_global(a, b, 0, cq_s, ca_s, has_q, has_a);
    slot_barrier(ctr, ++barriers * a.ctas);

    float c = 1.f, cost = 1.f;
    for (int k = 0;; ++k) {
      // pass k's maxima: Q after dt_{k-1} (before c_{k-1}), A0 after e_{k-1}
      const unsigned* g = a.cmax + ((size_t)b * (a.iters + 1) + k) * 2 * n;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        cq_s[i] = __ldcg(g + i);
        ca_s[i] = __ldcg(g + n + i);
      }
      __syncthreads();
      if (k > 0) {   // c_{k-1} = 1 / limit(max(limit(max|p'|), mean))
        if (threadIdx.x < 32) {
          const float mean = __fmul_rn(
              torch_order_sum(reinterpret_cast<const float*>(cq_s), n, a.W),
              a.mean_factor);
          if (threadIdx.x == 0)
            *c_s = __fdiv_rn(1.0f, limit(maximum(*pm_s, mean)));
        }
        __syncthreads();
        c = *c_s;
        cost = __fmul_rn(c, cost);
      }
      if (k == a.iters) break;
      // sweep k's factors; p ← dt·(c·p), d ← dt·d (this CTA's slice)
      float pm = 0.f;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const float cqv = __uint_as_float(cq_s[i]);
        const float colq = k > 0 ? __fmul_rn(c, cqv) : cqv;
        const float dtv =
            inv_sqrt(limit(maximum(colq, __uint_as_float(ca_s[i]))));
        dt_s[i] = dtv;
        float pv = p_s[i];
        if (k > 0) pv = __fmul_rn(c, pv);
        pv = __fmul_rn(dtv, pv);
        p_s[i] = pv;
        pm = fmaxf(pm, fabsf(pv));
        if (i >= d0 && i < d1) db[i] = k == 0 ? dtv : __fmul_rn(dtv, db[i]);
      }
      pm = block_max(pm, red);   // ends in a barrier: dt_s complete
      if (threadIdx.x == 0) *pm_s = limit(pm);
      for (int i = threadIdx.x; i < r1 - r0; i += THREADS) {
        const int r = r0 + i;
        if (r < n) {
          fac_s[i] = dt_s[r];
        } else {
          const float et = inv_sqrt(limit(rmax_s[i]));
          fac_s[i] = et;
          e_s[i] = __fmul_rn(et, e_s[i]);
          zl_s[i] = __fmul_rn(et, zl_s[i]);
          zu_s[i] = __fmul_rn(et, zu_s[i]);
        }
      }
      for (int i = threadIdx.x; i < n; i += THREADS) {
        cq_s[i] = 0u;
        ca_s[i] = 0u;
      }
      __syncthreads();
      sweep_pass<V>(I, store, store, k > 0, c, dt_s, fac_s, rmax_s, cq_s,
                    ca_s);
      __syncthreads();
      fold_global(a, b, k + 1, cq_s, ca_s, has_q, has_a);
      slot_barrier(ctr, ++barriers * a.ctas);
    }
    // the last cost factor; write everything this CTA owns
    const bool swept = a.iters > 0;
    final_pass<V>(I, store, OUT, swept, c);
    if (j == 0) {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        a.po[(size_t)b * n + i] = swept ? __fmul_rn(c, p_s[i]) : p_s[i];
        if (!swept) db[i] = 1.f;
      }
      if (threadIdx.x == 0) a.cost[b] = cost;
    }
    for (int i = threadIdx.x; i < r1 - r0; i += THREADS) {
      const int r = r0 + i - n;
      if (r >= 0) {
        a.e[(size_t)b * m + r] = e_s[i];
        a.zlo[(size_t)b * m + r] = zl_s[i];
        a.zuo[(size_t)b * m + r] = zu_s[i];
      }
    }
    __syncthreads();
  }
}

// ---- host -------------------------------------------------------------------

struct Plan {
  int resident, slots, ctas, R;
  size_t smem;
};

static int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess)
    return 0;
  return v;
}

static size_t smem_bytes(int n, int R, bool resident) {
  return sizeof(float) * (size_t)Lay(n, R, resident).total;
}

// How a launch lays B instances of n + m rows over one CTA an SM: resident
// where the rows of an instance fit the shared memory of at most every SM
// (as many instances at a time as fit, the SMs shared evenly among them),
// else one instance at a time with its rows in the outputs.  slots = 0:
// n too large for the vectors' shared memory.
static Plan make_plan(int B, int n, int m) {
  Plan P{0, 0, 0, 0, 0};
  const int G = std::min(device_attr(cudaDevAttrMultiProcessorCount),
                         MAX_SLOTS);
  const size_t optin =
      (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int rows = n + m;
  if (G <= 0 || B <= 0 || rows <= 0) return P;
  // the most resident rows a CTA's shared memory takes
  const long long ld4 = (n + 3) / 4 * 4;
  long long est = ((long long)optin / 4 - 4 * ld4 - 64) / (ld4 + 5);
  int rmax = (int)std::max(0LL, std::min<long long>(est, rows));
  while (rmax > 0 && smem_bytes(n, rmax, true) > optin) --rmax;
  while (rmax < rows && smem_bytes(n, rmax + 1, true) <= optin) ++rmax;
  const int cmin = rmax > 0 ? (rows + rmax - 1) / rmax : 0;
  if (cmin > 0 && cmin <= G) {
    P.resident = 1;
    P.slots = std::min(B, G / cmin);
    P.ctas = G / P.slots;
  } else {
    P.slots = 1;
    P.ctas = G;
  }
  P.R = (rows + P.ctas - 1) / P.ctas;
  P.smem = smem_bytes(n, P.R, P.resident);
  if (P.smem > optin) P.slots = 0;
  return P;
}

static int last_pow2(long long x) {
  int p = 1;
  while ((long long)p * 2 <= x) p *= 2;
  return p;
}

// The block width PyTorch's reduction takes for a mean over the contiguous
// last dimension of a (B, n) float32 tensor, vectorized by 4 (ReduceConfig:
// at most 512 threads, block.x first up to a warp, block.y over outputs up
// to what is left, block.x widened into the rest); at least a warp.
static int mean_width(int B, int n) {
  const long long dim0 = n / 4;
  const int d0 = dim0 < 512 ? last_pow2(dim0 > 0 ? dim0 : 1) : 512;
  const int d1 = B < 512 ? last_pow2(B) : 512;
  int bw = std::min(d0, 32);
  const int bh = std::min(d1, 512 / bw);
  bw = std::min(d0, 512 / bh);
  return std::max(bw, 32);
}

template <int V>
static int launch(Args a, const Plan& P, cudaStream_t stream) {
  auto kernel = ruiz_kernel<V>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)P.smem);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    P.smem) != cudaSuccess ||
      per_sm < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.slots * P.ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = P.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ruiz
}  // namespace iadmm

using namespace iadmm;

extern "C" {

// The launch's layout for B instances of n columns and n + m rows on the
// current device: out = {resident, slots, CTAs a slot, rows a CTA, shared
// memory bytes, the mean's block width}.  Returns 0, or 1 where n is too
// large for the kernel's shared memory.
int iadmm_ruiz_plan(int B, int n, int m, int* out) {
  const ruiz::Plan P = ruiz::make_plan(B, n, m);
  out[0] = P.resident;
  out[1] = P.slots;
  out[2] = P.ctas;
  out[3] = P.R;
  out[4] = (int)P.smem;
  out[5] = ruiz::mean_width(B, n);
  return P.slots > 0 ? 0 : 1;
}

// All `iters` sweeps of Ruiz scaling, float32: Q (B,n,n), p (B,n), A0
// (B,m,n), zl, zu (B,m) in; the scaled Qo, po, Ao, zlo, zuo and the factors
// d (B,n), e (B,m), cost (B,) out.  ws: MAX_SLOTS + B·(iters+1)·2n
// 32-bit words of scratch, zeroed here.  Inputs 16-byte aligned.
int iadmm_ruiz_scale(const void* Q, const void* p, const void* A0,
                     const void* zl, const void* zu, void* Qo, void* po,
                     void* Ao, void* zlo, void* zuo, void* d, void* e,
                     void* cost, void* ws, int B, int n, int m, int iters,
                     void* stream) {
  if (B <= 0 || n <= 0 || iters < 0) return 0;
  const ruiz::Plan P = ruiz::make_plan(B, n, m);
  if (P.slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t words =
      ruiz::MAX_SLOTS + (size_t)B * (iters + 1) * 2 * (size_t)n;
  cudaMemsetAsync(ws, 0, words * sizeof(unsigned), s);
  unsigned* w = static_cast<unsigned*>(ws);
  ruiz::Args a{static_cast<const float*>(Q),  static_cast<const float*>(p),
               static_cast<const float*>(A0), static_cast<const float*>(zl),
               static_cast<const float*>(zu), static_cast<float*>(Qo),
               static_cast<float*>(po),       static_cast<float*>(Ao),
               static_cast<float*>(zlo),      static_cast<float*>(zuo),
               static_cast<float*>(d),        static_cast<float*>(e),
               static_cast<float*>(cost),     w,
               w + ruiz::MAX_SLOTS,           B,
               n,                             m,
               iters,                         P.slots,
               P.ctas,                        P.R,
               P.resident,                    (n + 3) / 4 * 4,
               ruiz::mean_width(B, n),
               (float)B / (float)((long long)B * n)};
  return n % 4 == 0 ? ruiz::launch<4>(a, P, s) : ruiz::launch<1>(a, P, s);
}

}  // extern "C"
