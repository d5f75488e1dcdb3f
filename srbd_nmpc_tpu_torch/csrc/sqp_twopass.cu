// K4a / K4b · two-pass fused SQP QP solve (dense): K4a's terminal-and-merit
// pass and K4b's rollout, one thread per scenario.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/sqp_pallas.py::_bwd_kernel (K4a)
// and ::_fwd_kernel (K4b), the two pallas_calls of sqp_qp_solve. Contract: the
// plain PyTorch versions srbd_nmpc_tpu_torch/ops/sqp_kernel.py::
// sqp_qp_backward_ref and ::sqp_qp_forward_ref. No engine route runs it: it is
// the two-pass oracle the one-pass kernels (K3) are held against, and the
// "twopass" variant of the JAX tools.
//
// K4a, stages k = N-1 ... 0: the dense Euler sensitivities A = I + dt J_fx,
// B = dt J_fu (srbd_soa.euler_AB, K5's order), the four-call RK4 defect, the
// relaxed barrier through the full Ac [24,12] (R_eff = R + Ac' diag(ddb) Ac), a
// dense Riccati stage in K6's rounding order (G = R_eff + B'PB + reg I not
// symmetrized, right-looking Cholesky with dinv = rsqrt(pivot), K and kv from
// one 13-column solve, P <- (P_new + P_new') / 2), and the merit accumulated in
// backward stage order. It writes Acl = A + B K, K, bcl = b + B kv, kv, q,
// r_eff per stage, q_N and the merit. K4b rolls dx_{k+1} = Acl dx_k + bcl,
// du_k = K dx_k + kv forward and forms dphi (srbd_dev.cuh, shared with K3).
//
// What bounds K4a on the H100: in one thread per scenario it is latency- and
// register-bound (dense 12x12 products on P, P A, H, the factor and the
// 13-column right-hand side, plus A and B, all spilled: 255 registers, ~15
// KB of spill stores, PERF.md); it writes 1,344 bytes per stage and
// scenario. K4b reads those back once: bound by bytes. Every global array
// is indexed (row * B + lane), so consecutive threads touch consecutive
// addresses. Full-precision math, -fmad=false, the plain version's sum
// order.
//
// What K4a's design does about it (ops/sqp_kernel.py::_k4a_split, four
// launches of kernels that other paths already run): K5's stage pass and
// dense write (linearize.cu) write A, B, R_eff, b, q and r_eff straight into
// K4a's buffers, with K5's merit rows; k4s_merit_kernel here, a thread per
// lane, forms q_N into row N of the q buffer and reduces the merit over
// k = N-1 ... 0 from K5's rows in merit_accumulate's grouping; K6a's team
// pass (riccati.cu riccati_team_acl_kernel, K6a's kernel with a compile-time
// flag) runs the stage over shared memory, a team of 16 per scenario, and
// also forms Acl = A + B K and bcl = b + B kv, which the block writes beside
// K and k. The four launches move more bytes than one thread per scenario
// did (A, B, R_eff go through device memory: ~13.8 GB a call at N=20,
// B=131072 against ~3.9 GB) and are bound by K6a's team pass.

#include "srbd_dev.cuh"

namespace k4 {

using namespace srbd_dev;

// constants block (offsets match ops/sqp_kernel.py::_K4_*): mass, dt, Iinv[9],
// foot[6], then Ac [24,12], bc [24], R, Q, Qf [12,12]
constexpr int K_AC = 17, K_BC = 305, K_R = 329, K_Q = 473, K_QF = 617, K_LEN = 761;

#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]

// K4a's split, its terminal-and-merit pass for one lane (Qf row-major):
// qN = Qf eN into row N of q [N+1, 12, B], phi_N, and the merit from K5's
// per-stage rows (mer [N, 8, B]: 1/2 |b|^2, barrier sum, min constraint,
// max |b|, 1/2 u'Ru, 1/2 ex'q) accumulated over k = N-1 ... 0 as
// merit_accumulate groups them: theta + mer0, phi + ((mer1 + mer4) + mer5)
template <typename T>
HD void merit_pass(const T* Qf, const T* xa, const T* xr, const T* mer, T* q, T* theta_out,
                   T* phi_out, T* maxdef_out, T* mincon_out, int N, int B, int b) {
  T eN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) eN[i] = AT(xa, N * 12 + i) - AT(xr, N * 12 + i);
  T sN = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Qf[12 * i] * eN[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
    AT(q, N * 12 + i) = acc;
    sN = (i == 0) ? eN[0] * acc : sN + eN[i] * acc;
  }
  Merit<T> m = merit_seed(T(0.5) * sN);
  for (int k = N - 1; k >= 0; --k) {
    const T* mk = mer + (size_t)k * 8 * B;
    m.th = m.th + AT(mk, 0);
    m.ph = m.ph + ((AT(mk, 1) + AT(mk, 4)) + AT(mk, 5));
    m.md = nan_max(m.md, AT(mk, 3));
    m.mc = nan_min(m.mc, AT(mk, 2));
  }
  AT(theta_out, 0) = m.th;
  AT(phi_out, 0) = m.ph;
  AT(maxdef_out, 0) = m.md;
  AT(mincon_out, 0) = m.mc;
}

// K4b: the rollout of K4a's products from dx_0
template <typename T>
HD void forward(const T* Acl, const T* Kp, const T* bcl, const T* kv, const T* q,
                const T* rf, const T* qNp, const T* dx0, T* dx_out, T* du_out, T* dphi,
                int N, int B, int b) {
  T dx[12], qN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    dx[i] = AT(dx0, i);
    qN[i] = AT(qNp, i);
  }
  AT(dphi, 0) = closed_loop_rollout(Acl, Kp, bcl, kv, q, rf, qN, dx, dx_out, du_out, N, B, b);
#undef AT
}

}  // namespace k4

#ifdef __CUDACC__

__global__ void sqp_twopass_fwd_kernel(const float* Acl, const float* K, const float* bcl,
                                       const float* kv, const float* q, const float* rf,
                                       const float* qN, const float* dx0, float* dx_out,
                                       float* du_out, float* dphi, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k4::forward<float>(Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B, b);
}

__global__ void __launch_bounds__(128)
    k4s_merit_kernel(const float* __restrict__ consts, const float* xa, const float* xr,
                     const float* mer, float* q, float* theta, float* phi, float* maxdef,
                     float* mincon, int N, int B) {
  __shared__ float qf[144];
  for (int i = threadIdx.x; i < 144; i += blockDim.x) qf[i] = consts[k4::K_QF + i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k4::merit_pass<float>(qf, xa, xr, mer, q, theta, phi, maxdef, mincon, N, B, b);
}

// K4a's split, its terminal-and-merit pass: qN into q [N+1, 12, B] row N,
// the merit from K5's rows mer [N, 8, B]
extern "C" int srbd_k4s_merit_launch(const float* consts, const float* xa, const float* xr,
                                     const float* mer, float* q, float* theta, float* phi,
                                     float* maxdef, float* mincon, int N, int B,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k4s_merit_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      consts, xa, xr, mer, q, theta, phi, maxdef, mincon, N, B);
  return (int)cudaGetLastError();
}

extern "C" int srbd_sqp_twopass_fwd_launch(const float* Acl, const float* K, const float* bcl,
                                           const float* kv, const float* q, const float* rf,
                                           const float* qN, const float* dx0, float* dx_out,
                                           float* du_out, float* dphi, int N, int B,
                                           int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  sqp_twopass_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the same per-lane bodies over every lane

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

extern "C" int srbd_k4s_merit_host(const host_t* consts, const host_t* xa, const host_t* xr,
                                   const host_t* mer, host_t* q, host_t* theta, host_t* phi,
                                   host_t* maxdef, host_t* mincon, int N, int B) {
  for (int b = 0; b < B; ++b)
    k4::merit_pass<host_t>(consts + k4::K_QF, xa, xr, mer, q, theta, phi, maxdef, mincon, N,
                           B, b);
  return 0;
}

extern "C" int srbd_sqp_twopass_fwd_host_f64(const host_t* Acl, const host_t* K,
                                             const host_t* bcl, const host_t* kv,
                                             const host_t* q, const host_t* rf,
                                             const host_t* qN, const host_t* dx0,
                                             host_t* dx_out, host_t* du_out, host_t* dphi,
                                             int N, int B) {
  for (int b = 0; b < B; ++b)
    k4::forward<host_t>(Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B, b);
  return 0;
}

#endif
