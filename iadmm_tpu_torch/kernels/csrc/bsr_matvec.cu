// Block-sparse (BSR) batched matvec for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/sparse_matvec.py::_bsr_matvec_kernel (driven
// there by bsr_matvec).  For each instance b and row-tile r:
//
//   out[b, r*TM + i] = sum_k sum_j vals[b,r,k,i,j] * rnd(v[b, cols[b,r,k]*TN + j])
//
// where rnd rounds to the tile dtype (bf16 tiles: the vector segment is
// rounded to bf16 before the product, as the TPU kernel's
// seg.astype(tile.dtype); f32 tiles: no rounding) and v reads as zero past
// n.  Products are summed in float32 with plain FMA (no tensor cores, no
// TF32); a bf16 x bf16 product is exact in float32.
//
// Bound on the H100: bytes.  One call reads each stored tile once
// (B*R*K*TM*TN elements), its column indices and the vector, and writes
// (B, m) float32; at 2 flops per tile element it is far below the
// tensor-core ridge.  At Sparse_QP_Large (n = 4096, (8, 128) bf16 tiles,
// K = 2) one Q matvec moves 2.1 MB per instance.
//
// Design: one CTA of 8 warps per (8-row block of a row-tile, instance);
// warp w owns output row r*TM + 8*blk + w.  For each stored tile k, in
// order, the block stages the tile's TN-wide vector segment (rounded) in
// shared memory once for its 8 rows; each lane then reads TN/32 = 4
// contiguous tile elements with one vector load and accumulates their
// products into its own float32 partial.  After the last tile the warp sums
// its 32 partials with a fixed xor-shuffle tree.  Every sum runs in a fixed
// order, so repeat calls are bitwise equal.  Rows past m (the ragged last
// row-tile) are computed on the zero pad and not written.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int TN = 128;            // column-tile width (the wrapper checks)
constexpr int ROWS = 8;            // rows (warps) per CTA
constexpr int PER_LANE = TN / 32;  // tile elements per lane

template <typename T>
struct Quad;

template <>
struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
};

template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    out[0] = __low2float(lo); out[1] = __high2float(lo);
    out[2] = __low2float(hi); out[3] = __high2float(hi);
  }
};

template <typename T>
__global__ void __launch_bounds__(ROWS * 32)
bsr_matvec_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                  const float* __restrict__ v, float* __restrict__ out,
                  int R, int K, int TM, int m, int n) {
  __shared__ float seg[TN];
  const int blocks_per_tile = TM / ROWS;
  const int r = blockIdx.x / blocks_per_tile;
  const int blk = blockIdx.x % blocks_per_tile;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blk * ROWS + warp;  // row within the tile
  const size_t tile_elems = static_cast<size_t>(TM) * TN;
  const size_t rk = (static_cast<size_t>(b) * R + r) * K;
  const T* tile_row = vals + rk * tile_elems + static_cast<size_t>(i) * TN +
                      lane * PER_LANE;
  const float* vb = v + static_cast<size_t>(b) * n;

  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int c0 = cols[rk + k] * TN;
    __syncthreads();  // the previous tile's segment is no longer read
    if (threadIdx.x < TN) {
      const int j = c0 + threadIdx.x;
      const float x = j < n ? vb[j] : 0.f;
      seg[threadIdx.x] = iadmm::to_f(iadmm::from_f<T>(x));
    }
    __syncthreads();
    float a[PER_LANE];
    Quad<T>::load(tile_row + k * tile_elems, a);
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q)
      acc = fmaf(a[q], seg[lane * PER_LANE + q], acc);
  }
  acc = iadmm::warp_sum(acc);
  const int row = r * TM + i;
  if (lane == 0 && row < m) out[static_cast<size_t>(b) * m + row] = acc;
}

}  // namespace

extern "C" {

// vals: (B, R, K, TM, 128) bf16 (is_bf16 = 1) or float32, 16-byte aligned;
// cols: (B, R, K) int32, each in [0, ceil(n/128)); v: (B, n) float32;
// out: (B, m) float32.  TM must be a multiple of 8 (the wrapper allows 8
// and 128).  Returns cudaGetLastError() after the launch.
int iadmm_bsr_matvec(const void* vals, const void* cols, const void* v,
                     void* out, int B, int R, int K, int TM, int m, int n,
                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(R * (TM / ROWS), B);
  const dim3 block(ROWS * 32);
  const int* c = static_cast<const int*>(cols);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    bsr_matvec_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), c, vf, o, R, K, TM, m, n);
  else
    bsr_matvec_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vals), c, vf, o, R, K, TM, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
