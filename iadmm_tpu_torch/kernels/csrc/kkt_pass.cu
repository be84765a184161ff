// The KKT pass of kkt_matvec.cuh alone, for Hopper (sm_90a): one read of
// [Q; A0] against one or two right-hand sides.  Every learned iteration
// runs it twice (rollout.cu, train_fwd.cu), the backward six times a step
// (train_bwd.cu), Stage II once a polish step and once a CG iteration
// (stage2.cu); here it is bound on its own so that the tests and
// chip_smoke.py can hold it against kernels/kkt_pass.py::kkt_pass_plain and
// time it.  It is a part of the TPU kernels' steps (their _mv_maker
// products), not a TPU kernel of its own.

#include "kkt_matvec.cuh"

using namespace iadmm;

extern "C" {

// Q (B,n,n), A0 (B,m,n) in bf16 (f32 = 0: vectors rounded to bf16) or
// float32 (f32 = 1).  Right-hand side k: wt_k (B,n), wb_k (B,m) float32,
// out partial_k (B, ceil((n+m)/32), n), rowdot_k (B,m) float32.  wt2 null:
// one right-hand side.
int iadmm_kkt_pass(const void* Q, const void* A0, const void* wt1,
                   const void* wb1, void* partial1, void* rowdot1,
                   const void* wt2, const void* wb2, void* partial2,
                   void* rowdot2, int B, int n, int m, int f32,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kkt::Rhs r1{static_cast<const float*>(wt1), n,
                    static_cast<const float*>(wb1), m,
                    static_cast<float*>(partial1),
                    static_cast<float*>(rowdot1)};
  const kkt::Rhs r2{static_cast<const float*>(wt2), n,
                    static_cast<const float*>(wb2), m,
                    static_cast<float*>(partial2),
                    static_cast<float*>(rowdot2)};
  if (f32) {
    if (wt2)
      kkt::colpass2<float, false>(Q, A0, r1, r2, n, m, B, s);
    else
      kkt::colpass<float, false>(Q, A0, r1.wt, n, r1.wb, m, r1.partial,
                                 r1.rowdot, n, m, B, s);
  } else {
    if (wt2)
      kkt::colpass2<__nv_bfloat16, true>(Q, A0, r1, r2, n, m, B, s);
    else
      kkt::colpass<__nv_bfloat16, true>(Q, A0, r1.wt, n, r1.wb, m,
                                        r1.partial, r1.rowdot, n, m, B, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
