// Per-step fused LSTM token cell for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/lstm_cell.py::_cell_kernel (driven there by
// _pallas_forward / fused_lstm_cell).  The GEMM, its epilogue, the bound and
// the design are described in cell_gemm.cuh; this file adds the second pass
// that sums the per-tile delta partials in a fixed order and adds b_h.
//
// Inputs are rounded to bf16 before the x·W term, as the TPU kernel's
// mm(x, W) casts them (lstm_cell.py:60-65).  H' and C' are written in the
// dtypes of H and C (bf16 or float32 each).

#include "cell_gemm.cuh"

namespace {

__global__ void delta_kernel(const float* __restrict__ partial, int ntiles,
                             const float* __restrict__ bh,
                             float* __restrict__ delta, int M) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  float d = 0.f;
  for (int t = 0; t < ntiles; ++t) d += partial[(size_t)t * M + r];
  delta[r] = d + bh[0];
}

}  // namespace

extern "C" {

// x: (M, 2) float32 token inputs; H, C: (M, h) bf16 or float32 (h_bf16,
// c_bf16 say which); W: (2, 4h), U: (h, 4h), Wh: (h,) bf16; b: (4h,), bh: (1,)
// float32.  Writes H_out, C_out (dtypes of H, C), delta (M,) float32, using
// partial (ceil(h/16), M) float32 as scratch.
int iadmm_cell_forward(const void* x, const void* H, const void* C,
                       const void* W, const void* U, const void* b,
                       const void* Wh, const void* bh, void* H_out,
                       void* C_out, void* partial, void* delta, int M, int h,
                       int h_bf16, int c_bf16, void* stream) {
  using namespace iadmm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* part = static_cast<float*>(partial);
  const float* bias = static_cast<const float*>(b);
  if (h_bf16 && c_bf16)
    cell::launch<__nv_bfloat16, __nv_bfloat16>(xf, xf + 1, 2, 1, H, C, W, U,
                                               bias, Wh, H_out, C_out, part,
                                               M, h, s);
  else if (h_bf16)
    cell::launch<__nv_bfloat16, float>(xf, xf + 1, 2, 1, H, C, W, U, bias, Wh,
                                       H_out, C_out, part, M, h, s);
  else if (c_bf16)
    cell::launch<float, __nv_bfloat16>(xf, xf + 1, 2, 1, H, C, W, U, bias, Wh,
                                       H_out, C_out, part, M, h, s);
  else
    cell::launch<float, float>(xf, xf + 1, 2, 1, H, C, W, U, bias, Wh, H_out,
                               C_out, part, M, h, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  delta_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      part, cell::n_tiles(h), static_cast<const float*>(bh),
      static_cast<float*>(delta), M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
