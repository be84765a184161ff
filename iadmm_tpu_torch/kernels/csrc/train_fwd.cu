// The learned ADMM iterations of a TBPTT training chunk, forward, for
// Hopper (sm_90a), with the per-step losses and the state streams the
// backward reads.
//
// Replaces iadmm_tpu/kernels/train_rollout.py::_fwd_stream_kernel (built by
// make_fused_chunk_loss(stream=True)).  The TPU kernel runs the J steps of
// one instance per grid step with Q, A0 and the recurrent state in VMEM and
// DMAs every pre-step state to HBM.  Here one call runs the J steps of the
// chunk from C++ (iadmm_train_fwd_chunk), step k (schedule index t0 + k)
// launching
//   1-6. admm::iteration         the rollout's six launches, from slot k to
//                                slot k+1 (admm_step.cuh): r = Ã·xv − b̃,
//                                g = Ã·r, the cell GEMM (gates, C', H',
//                                delta partials), the xv, x, y, z update;
//                                from k = 1 the pass of step 1 also reads
//                                [Q; A0] against (x_k, y_k), the state that
//                                step k−1 wrote, and finish forms its loss
//                                vectors v1 = A0·x_k − z_k and
//                                v2 = Q·x_k + A0ᵀ·y_k + p (kkt_matvec.cuh's
//                                second right-hand side)
// and after the last step
//   7.   colpass(x_J, y_J), loss_vec   the last step's loss vectors
//   8.   loss                          pr[b,c] = ‖v1‖, dr[b,c] = ‖v2‖ for
//                                      every column c of the call at once
// So [Q; A0] is read twice a step, not three times: the loss pass of step
// k−1 and the features pass of step k share one read (the sums of each
// right-hand side keep their order, so the losses are those of a pass of
// their own, bit for bit).  The loss vectors of the call's steps wait in
// lv, one (B, n+m) slab a column.
//
// Two compute dtypes (the entry point's f32 flag), as the TPU kernel's
// compute_dtype: bf16 (Q, A0, W, U, W_h in bf16, every vector rounded to
// bf16 before a matvec, the wgmma gate GEMM of cell_gemm.cuh) or float32
// (all of them float32, nothing rounded, the gate GEMM on the CUDA cores in
// FFMA; the TPU kernel runs these products at Precision.HIGHEST).
//
// The streams are the carries.  They are step-major, slot k·B + b, rather
// than the TPU kernel's b·(J+1) + k, so that a step's slab is contiguous and
// the kernels address it as rollout.cu addresses its carries:
//   hs (J+1, B·S, h) cdt    H as the gate GEMM consumes it: the GEMM reads
//                           slot k and its epilogue writes H' (bf16(H') in
//                           the bf16 profile) to k+1
//   cs (J+1, B·S, h) f32    C: read from slot k, C' written to k+1
//   xs, ys, zs, xvs (J+1, B, ·) f32
// Slot 0 holds the chunk's start state (the wrapper copies it in), slot J the
// final one.  H is carried in float32 on the TPU and rounded to bf16 where it
// is consumed; the gate GEMM rounds it when the epilogue stores slot k+1, so
// the values are the same.  The final H' is also written unrounded in
// float32 to H_final on the last step.
//
// Bound on the H100 at B=2, S=2000, h=800, J=100: the gate GEMM,
// J·2·B·S·h·4h = 2.05 TFLOP, 2.07 ms at 989 TFLOP/s (bf16) or 30.6 ms at 67
// TFLOP/s (float32), against 1.92 GB (bf16 H) or 2.56 GB (float32 H) of
// stream writes (0.57 / 0.76 ms at 3.35 TB/s): operations.  Beside the
// GEMM, a step reads [Q; A0] twice (8 MB of bf16 at B = 2, which the L2
// holds; 64 MB at B = 16, which it does not).
//
// iadmm_train_fwd_seg replaces _fwd_seg_kernel, the forward of the segment
// route (make_fused_chunk_loss with stream=False, seg > 0, or streams over
// IADMM_STREAM_HBM): the same steps over carries of two slots instead of
// J+1, one call per segment of J steps, no stream written.  The wrapper
// keeps each segment's start state (H and C in float32) as the checkpoint
// that train_bwd.cu's segment entry point recomputes from.  The loss pass
// folds across calls too: a segment's first step carries the loss of the
// previous segment's last step (its start state), and only the chunk's
// last segment closes with a pass of its own.  Its bound is the same GEMM
// operations as the stream forward's.

#include "admm_step.cuh"

namespace {

using namespace iadmm;

// lv[c, b, :] = the loss vectors of the state (x, y, z) from the pass over
// (x, y): admm::loss_vec for every element, one thread each.
__global__ void loss_vec_kernel(const float* __restrict__ partial,
                                const float* __restrict__ rowdot,
                                int nchunks, const float* __restrict__ p,
                                const float* __restrict__ z,
                                float* __restrict__ lv, int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  lv[idx] = admm::loss_vec(partial, rowdot, nchunks, p, z, idx / S, idx % S,
                           n, m);
}

// One CTA per instance and loss column c (blockIdx.y) of lv (ncols, B,
// n+m): pr[b, col0 + c] = ‖v1‖, dr[b, col0 + c] = ‖v2‖, each thread's
// strided squares then block_sum (a fixed order).
__global__ void loss_kernel(const float* __restrict__ lv, int col0, int L,
                            float* __restrict__ pr, float* __restrict__ dr,
                            int n, int m, int B) {
  __shared__ float scratch[33];
  const int b = blockIdx.x, c = blockIdx.y;
  const float* v = lv + ((size_t)c * B + b) * (n + m);
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float v1 = v[n + i];
    s1 += v1 * v1;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v2 = v[j];
    s2 += v2 * v2;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    pr[b * L + col0 + c] = sqrtf(s1);
    dr[b * L + col0 + c] = sqrtf(s2);
  }
}

// The buffers of a call (see the entry points).
struct Bufs {
  void *hs, *cs, *xs, *ys, *zs, *xvs, *H_final, *pr, *dr, *r, *g;
  admm::KktScratch ks, ks2;
  float* lv;
  float* cell_partial;
};

// Steps i = 0 … nsteps−1 (schedule index t0 + i), from slot i to i + 1
// of the streams or, with two_slots, from slot i mod 2 to the other one;
// the last step's H' also goes to H_final.  Step i's loss lands at column
// col + i of the (B, L) pr, dr.  pending: the start state's loss (column
// col − 1) is still to be taken, by step 0's first pass; close: take the
// last step's loss here (else the next call's step 0 does).  lv holds
// nsteps + 1 slabs: column c in slab c − col + 1.
template <typename T>
void run(const admm::Problem& P, const admm::Weights& w, const Bufs& f,
         int t0, int nsteps, bool two_slots, int col, int L, bool pending,
         bool close, cudaStream_t s) {
  const int B = P.B, n = P.n, m = P.m;
  const int M = B * (n + m);
  const size_t slab = (size_t)M * w.h;
  auto at = [](void* base, int slot, size_t len) {
    return static_cast<float*>(base) + (size_t)slot * len;
  };
  int dst = 0;
  for (int i = 0; i < nsteps; ++i) {
    const int src = two_slots ? (i & 1) : i;
    dst = two_slots ? ((i + 1) & 1) : i + 1;
    const admm::Loss loss{f.ks2, f.lv + (size_t)i * M};   // column col + i − 1
    admm::iteration<T>(
        P, w, t0 + i, at(f.xvs, src, M), at(f.xs, src, B * n),
        at(f.ys, src, B * m), at(f.zs, src, B * m),
        static_cast<const T*>(f.hs) + src * slab, at(f.cs, src, slab),
        at(f.xvs, dst, M), at(f.xs, dst, B * n), at(f.ys, dst, B * m),
        at(f.zs, dst, B * m), static_cast<T*>(f.hs) + dst * slab,
        at(f.cs, dst, slab),
        i == nsteps - 1 ? static_cast<float*>(f.H_final) : nullptr,
        static_cast<float*>(f.r), static_cast<float*>(f.g), f.cell_partial,
        f.ks, s, i > 0 || pending ? &loss : nullptr);
  }
  if (close) {
    const float* x = at(f.xs, dst, B * n);
    kkt::colpass<T, admm::kRound<T>>(P.Q, P.A0, x, n, at(f.ys, dst, B * m),
                                     m, f.ks2.partial, f.ks2.rowdot, n, m, B,
                                     s);
    loss_vec_kernel<<<admm::eblocks(M), 256, 0, s>>>(
        f.ks2.partial, f.ks2.rowdot, kkt::n_chunks(n, m), P.p,
        at(f.zs, dst, B * m), f.lv + (size_t)nsteps * M, n, m, B);
  }
  const int first = pending ? 0 : 1;            // slabs of this call's
  const int ncols = nsteps + (close ? 1 : 0) - first;   // columns
  if (ncols > 0)
    loss_kernel<<<dim3(B, ncols), 256, 0, s>>>(
        f.lv + (size_t)first * M, col - 1 + first, L,
        static_cast<float*>(f.pr), static_cast<float*>(f.dr), n, m, B);
}

int run_steps(int t0, int nsteps, bool two_slots, int col, int L,
              bool pending, bool close, const void* Q, const void* A0,
              const void* p, const void* zl, const void* zu,
              const void* rhom, const void* rho_raw, const void* alpha_raw,
              const void* W, const void* Ut, const void* b, const void* Wh,
              const void* bh, void* hs, void* cs, void* xs, void* ys,
              void* zs, void* xvs, void* H_final, void* pr, void* dr,
              void* r, void* g, void* mv_partial, void* rowdot,
              void* mv_partial2, void* rowdot2, void* lv, void* cell_partial,
              int B, int n, int m, int h, int f32, float sigma,
              void* stream) {
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
  const admm::Weights w{W, Ut, static_cast<const float*>(b), Wh,
                        static_cast<const float*>(bh), h};
  const Bufs f{hs, cs, xs, ys, zs, xvs, H_final, pr, dr, r, g,
               admm::KktScratch{static_cast<float*>(mv_partial),
                                static_cast<float*>(rowdot)},
               admm::KktScratch{static_cast<float*>(mv_partial2),
                                static_cast<float*>(rowdot2)},
               static_cast<float*>(lv), static_cast<float*>(cell_partial)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    run<float>(P, w, f, t0, nsteps, two_slots, col, L, pending, close, s);
  else
    run<__nv_bfloat16>(P, w, f, t0, nsteps, two_slots, col, L, pending, close,
                       s);
  return hop::last_error();
}

}  // namespace

extern "C" {

// The J steps of a chunk, schedule indices t0 … t0+J−1.  Q (B,n,n), A0
// (B,m,n), W (2,4h), Wh (h,) bf16, and Ut, U (h,4h) re-laid for the bf16
// cell GEMM (cell_gemm.cuh); or all float32 when f32, Ut then U itself;
// p (B,n), zl, zu, rhom (B,m), rho_raw/alpha_raw (K_total,), b (4h,), bh
// (1,) float32.  Streams as in the header (hs in the dtype of Q), slot 0
// the start state; step k reads slot k and writes k+1.  H_final (B·S, h)
// float32.  pr, dr (B, J) float32.  r, g (B,n+m), mv_partial and
// mv_partial2 (B, ceil((n+m)/32), n), rowdot and rowdot2 (B,m), lv
// (J+1, B, n+m), cell_partial (cell::n_partials(h), B·(n+m)) are scratch.
int iadmm_train_fwd_chunk(int t0, const void* Q, const void* A0,
                          const void* p, const void* zl, const void* zu,
                          const void* rhom, const void* rho_raw,
                          const void* alpha_raw, const void* W,
                          const void* Ut, const void* b, const void* Wh,
                          const void* bh, void* hs, void* cs, void* xs,
                          void* ys, void* zs, void* xvs, void* H_final,
                          void* pr, void* dr, void* r, void* g,
                          void* mv_partial, void* rowdot, void* mv_partial2,
                          void* rowdot2, void* lv, void* cell_partial, int B,
                          int n, int m, int h, int J, int f32, float sigma,
                          void* stream) {
  return run_steps(t0, J, false, 0, J, false, true, Q, A0, p, zl, zu,
                   rhom, rho_raw, alpha_raw, W, Ut, b, Wh, bh, hs, cs, xs,
                   ys, zs, xvs, H_final, pr, dr, r, g, mv_partial, rowdot,
                   mv_partial2, rowdot2, lv, cell_partial, B, n, m, h, f32,
                   sigma, stream);
}

// Replaces _fwd_seg_kernel (train_rollout.py:147): one segment of J steps,
// schedule indices t0 … t0+J−1, from a checkpoint, keeping no stream.  The
// carries have two slots, hs (2, B·S, h) in the dtype of Q, cs (2, B·S, h),
// xs (2,B,n), ys, zs (2,B,m), xvs (2,B,S) float32, the checkpoint in slot 0
// (the wrapper copies it in); step k reads slot k mod 2 and writes the
// other, so the final state is in slot J mod 2 and its H', unrounded, in
// H_final (B·S, h) float32, as the TPU kernel writes out its float32 H
// carry.  Step k's losses land at column col + k of pr, dr (B, L), the
// chunk's.  pending (col > 0): the previous segment left its last loss
// (column col − 1) to this call, which takes it from the checkpoint;
// close: this call takes its own last loss (the chunk's last segment).  lv
// holds J+1 slabs.  The rest as in iadmm_train_fwd_chunk.  On the same
// start state the two routes give bitwise-equal states and losses.
int iadmm_train_fwd_seg(int t0, int col, int L, int pending, int close,
                        const void* Q, const void* A0, const void* p,
                        const void* zl, const void* zu, const void* rhom,
                        const void* rho_raw, const void* alpha_raw,
                        const void* W, const void* Ut, const void* b,
                        const void* Wh, const void* bh, void* hs, void* cs,
                        void* xs, void* ys, void* zs, void* xvs,
                        void* H_final, void* pr, void* dr, void* r, void* g,
                        void* mv_partial, void* rowdot, void* mv_partial2,
                        void* rowdot2, void* lv, void* cell_partial, int B,
                        int n, int m, int h, int J, int f32, float sigma,
                        void* stream) {
  return run_steps(t0, J, true, col, L, pending != 0, close != 0, Q, A0,
                   p, zl, zu, rhom, rho_raw, alpha_raw, W, Ut, b, Wh, bh, hs,
                   cs, xs, ys, zs, xvs, H_final, pr, dr, r, g, mv_partial,
                   rowdot, mv_partial2, rowdot2, lv, cell_partial, B, n, m,
                   h, f32, sigma, stream);
}

}  // extern "C"
