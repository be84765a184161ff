// Per-step fused LSTM token cell for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/lstm_cell.py::_cell_kernel (driven there by
// _pallas_forward / fused_lstm_cell).  The GEMM, its epilogue, the bound and
// the design are described in cell_gemm.cuh; this file adds the second pass
// that sums the delta partials in a fixed order and adds b_h.
//
// Two gate precisions (iadmm_cell_forward's gate_f32): bf16 weights, with
// the inputs rounded to bf16 before the x·W term as the TPU kernel's
// mm(x, W) casts them (lstm_cell.py:60-65), on the tensor cores (wgmma over
// U re-laid as Ut, hopper.cuh's core); or float32 weights, the TPU kernel's
// float32 gates at Precision.HIGHEST, on the CUDA cores with nothing
// rounded (gemm_f32.cuh's FFMA core under cell_gemm.cuh).  H' and C' are
// written in the dtypes of H and C (bf16 or float32 each).

#include "cell_gemm.cuh"

namespace {

__global__ void delta_kernel(const float* __restrict__ partial, int nparts,
                             const float* __restrict__ bh,
                             float* __restrict__ delta, int M) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  float d = 0.f;
  for (int t = 0; t < nparts; ++t) d += partial[(size_t)t * M + r];
  delta[r] = d + bh[0];
}

// The cell GEMM for weights TW and the H/C dtypes the flags name.
template <typename TW>
void launch_cell(const float* x, const void* H, const void* C, const void* W,
                 const void* Ut, const float* b,
                 const void* Wh, void* H_out, void* C_out, float* part, int M,
                 int h, int h_bf16, int c_bf16, cudaStream_t s) {
  using namespace iadmm;
  using bf16 = __nv_bfloat16;
  const int round_x = 1;  // x is the operand of a TW product
  if (h_bf16 && c_bf16)
    cell::launch<TW, bf16, bf16>(x, x + 1, 2, round_x, H, C, W, Ut, b, Wh,
                                 H_out, C_out, part, M, h, s);
  else if (h_bf16)
    cell::launch<TW, bf16, float>(x, x + 1, 2, round_x, H, C, W, Ut, b, Wh,
                                  H_out, C_out, part, M, h, s);
  else if (c_bf16)
    cell::launch<TW, float, bf16>(x, x + 1, 2, round_x, H, C, W, Ut, b, Wh,
                                  H_out, C_out, part, M, h, s);
  else
    cell::launch<TW, float, float>(x, x + 1, 2, round_x, H, C, W, Ut, b, Wh,
                                   H_out, C_out, part, M, h, s);
}

}  // namespace

extern "C" {

// x: (M, 2) float32 token inputs; H, C: (M, h) bf16 or float32 (h_bf16,
// c_bf16 say which); W: (2, 4h), Wh: (h,) bf16, or float32 when gate_f32;
// Ut: U (h, 4h) re-laid (cell_gemm.cuh) in bf16, or U itself when
// gate_f32; b: (4h,), bh: (1,) float32.  Writes H_out, C_out
// (dtypes of H, C), delta (M,) float32, using partial
// (cell::n_partials(h), M) float32 as scratch.
int iadmm_cell_forward(const void* x, const void* H, const void* C,
                       const void* W, const void* Ut,
                       const void* b, const void* Wh, const void* bh,
                       void* H_out, void* C_out, void* partial, void* delta,
                       int M, int h, int h_bf16, int c_bf16, int gate_f32,
                       void* stream) {
  using namespace iadmm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* part = static_cast<float*>(partial);
  const float* bias = static_cast<const float*>(b);
  auto launch = gate_f32 ? &launch_cell<float> : &launch_cell<__nv_bfloat16>;
  launch(xf, H, C, W, Ut, bias, Wh, H_out, C_out, part, M, h, h_bf16,
         c_bf16, s);
  const int e = hop::last_error();
  if (e != 0) return e;
  delta_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      part, cell::n_partials(h), static_cast<const float*>(bh),
      static_cast<float*>(delta), M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
