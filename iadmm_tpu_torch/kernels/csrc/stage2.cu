// One Stage-II exact polish step, solver 'kkt', for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/stage2_kernel.py::_stage2_kernel with
// solver='kkt' (driven there by fused_stage2).  The TPU kernel runs the N
// polish steps of one instance per grid step with Ã⁻¹, Q and A0 resident in
// VMEM.  Ã⁻¹ alone is 16 MB per instance in float32 at n = m = 1000, far
// beyond an SM's shared memory, so here the host loops over N and each step
// is a few launches that spread an instance over many CTAs:
//   1. rhs       b̃ = [σx − p ; z − y/ρ]
//   2. gemv      xv = Ã⁻¹·b̃, one warp per row of Ã⁻¹ (Ã⁻¹ is symmetric,
//                so the row-major product stands for the TPU's b̃ᵀ·Ã⁻¹)
//   3. `refine` times: colpass(xv) (kkt_matvec.cuh), r = b̃ − Ã·xv,
//                xv += Ã⁻¹·r
//   4. update    the z-relaxed ADMM update with α = 1.6
//   5. colpass([x; y]) and norms: pr = ‖A0x − z‖, dr = ‖Qx + p + A0ᵀy‖
// All arithmetic is float32 FMA: no tensor cores, so no TF32.
//
// Bound on the H100: bytes.  Each step reads Ã⁻¹ (4·(n+m)² bytes) and Q and
// A0 in float32 once per instance: 28 MB per instance at n = m = 1000,
// 224 MB for B = 8, about 67 µs at 3.35 TB/s.  The GEMV reads Ã⁻¹ with
// 16-byte loads when n+m is a multiple of 4.

#include "kkt_matvec.cuh"

namespace {

using namespace iadmm;

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

// out[b, i] (+)= Σ_j A[b, i, j]·v[b, j]: one warp per row, 8 rows per CTA.
__global__ void gemv_kernel(const float* __restrict__ A,
                            const float* __restrict__ v, float* out, int S,
                            int accumulate) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (row >= S) return;  // whole warp
  const float* a = A + ((size_t)b * S + row) * S;
  const float* vb = v + (size_t)b * S;
  float acc = 0.f;
  if ((S & 3) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* v4 = reinterpret_cast<const float4*>(vb);
    for (int j = lane; j < S / 4; j += 32) {
      const float4 x = a4[j], w = v4[j];
      acc = fmaf(x.x, w.x, acc);
      acc = fmaf(x.y, w.y, acc);
      acc = fmaf(x.z, w.z, acc);
      acc = fmaf(x.w, w.w, acc);
    }
  } else {
    for (int j = lane; j < S; j += 32) acc = fmaf(a[j], vb[j], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    float* o = out + (size_t)b * S + row;
    *o = accumulate ? *o + acc : acc;
  }
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
    ax = kkt::sum_partials(partial, b, nchunks, n, s) + sigma * xv[idx];
  } else {
    const int k = b * m + (s - n);
    ax = rowdot[k] - xv[idx] / rho[k];
  }
  r[idx] = bt[idx] - ax;
}

__global__ void update_kernel(const float* __restrict__ xv,
                              float* __restrict__ x, float* __restrict__ y,
                              float* __restrict__ z,
                              const float* __restrict__ zl,
                              const float* __restrict__ zu,
                              const float* __restrict__ rho, float alpha,
                              int n, int m, int B) {
  const int S = n + m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (s < n) {
    const int k = b * n + s;
    x[k] = alpha * xv[idx] + (1.0f - alpha) * x[k];
  } else {
    const int k = b * m + (s - n);
    const float rk = rho[k], yk = y[k], zk = z[k];
    const float zt = zk + (xv[idx] - yk) / rk;
    const float ztmp = alpha * zt + (1.0f - alpha) * zk;
    const float zn = fminf(fmaxf(ztmp + yk / rk, zl[k]), zu[k]);
    y[k] = yk + rk * (ztmp - zn);
    z[k] = zn;
  }
}

// pr[b, i] = ‖A0x − z‖, dr[b, i] = ‖Qx + p + A0ᵀy‖: one CTA per instance.
__global__ void norms_kernel(const float* __restrict__ partial,
                             const float* __restrict__ rowdot, int nchunks,
                             const float* __restrict__ z,
                             const float* __restrict__ p,
                             float* __restrict__ pr, float* __restrict__ dr,
                             int i, int N, int n, int m) {
  __shared__ float red[2][32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float sp = 0.f, sd = 0.f;
  for (int k = tid; k < m; k += blockDim.x) {
    const float v = rowdot[(size_t)b * m + k] - z[(size_t)b * m + k];
    sp = fmaf(v, v, sp);
  }
  for (int j = tid; j < n; j += blockDim.x) {
    const float v =
        kkt::sum_partials(partial, b, nchunks, n, j) + p[(size_t)b * n + j];
    sd = fmaf(v, v, sd);
  }
  sp = warp_sum(sp);
  sd = warp_sum(sd);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = sp;
    red[1][tid >> 5] = sd;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      a += red[0][w];
      c += red[1][w];
    }
    pr[(size_t)b * N + i] = sqrtf(a);
    dr[(size_t)b * N + i] = sqrtf(c);
  }
}

}  // namespace

extern "C" {

// Polish step i of N.  All float32.  Q (B,n,n), A0 (B,m,n), Ainv
// (B,n+m,n+m), p (B,n), zl, zu, rho (B,m).  x (B,n), y, z (B,m) are updated
// in place; xv (B,n+m) receives the solve.  bt, r (B,n+m), mv_partial
// (B, ceil((n+m)/32), n) and rowdot (B,m) are scratch.  pr, dr: (B, N).
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
  const dim3 ggrid((S + 7) / 8, B);
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

  rhs_kernel<<<eblocks, 256, 0, s>>>(xf, yf, zf, pf, rf, sigma, btf, n, m, B);
  gemv_kernel<<<ggrid, 256, 0, s>>>(A, btf, xvf, S, 0);
  for (int k = 0; k < refine; ++k) {
    kkt::colpass<float, false>(Q, A0, xvf, S, xvf + n, S, part, rd, n, m, B,
                               s);
    refine_kernel<<<eblocks, 256, 0, s>>>(part, rd, nch, xvf, btf, rf, sigma,
                                          res, n, m, B);
    gemv_kernel<<<ggrid, 256, 0, s>>>(A, res, xvf, S, 1);
  }
  update_kernel<<<eblocks, 256, 0, s>>>(
      xvf, xf, yf, zf, static_cast<const float*>(zl),
      static_cast<const float*>(zu), rf, alpha, n, m, B);
  kkt::colpass<float, false>(Q, A0, xf, n, yf, m, part, rd, n, m, B, s);
  norms_kernel<<<B, 256, 0, s>>>(part, rd, nch, zf, pf,
                                 static_cast<float*>(pr),
                                 static_cast<float*>(dr), i, N, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
