// Small device helpers shared by the kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iadmm {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to bf16 and widen back: the operand a bf16 product sees.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block in a fixed order: each warp's sum, then the warp
// sums in warp order by thread 0 (deterministic).  scratch: 33 floats of
// shared memory; every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
    scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

}  // namespace iadmm
