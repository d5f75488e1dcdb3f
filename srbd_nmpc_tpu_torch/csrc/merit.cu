// K7a · merit (theta, phi) at a line-search candidate, a stage pass and a
// reduction; and K7b · merit with diagnostics and (optionally) gradients,
// one thread per scenario.
//
// K7a replaces the TPU kernel srbd_nmpc_tpu/models/merit_pallas.py::
// _kernel_alpha (through merit_alpha_pallas); contract: the plain PyTorch
// version srbd_nmpc_tpu_torch/models/merit_kernel.py::merit_alpha_ref.
// K7b replaces merit_pallas.py::_kernel (GRAD) and ::_kernel_nograd (through
// merit_pallas); contract: merit_kernel.py::merit_ref.
//
// Per scenario, at the candidate (x + alpha dx, u + alpha du) with its own
// alpha: theta = sum over stages of 1/2 |x_{g+1} - rk4(x_g, u_g)|^2 (four
// dynamics calls, srbd_soa.rk4), and phi = sum over stages of the tracking
// cost 1/2 e'Qe, the relaxed barrier of the 24 friction-cone rows and
// 1/2 u'Ru, plus the terminal 1/2 e_N' Qf e_N.
//
// What bounds K7a on the H100: the RK4 chain (four SO(3) chain evaluations
// per stage) and reading the candidate's inputs (x, dx, u, du, x_ref: ~250
// bytes per stage and scenario, 0.65 GB a call at N=20, B=131072). In one
// thread per scenario the stages run in series: 255 registers, ~1.8 KB of
// spill stores, and only 131,072 threads, 8 warps an SM (PERF.md).
//
// What K7a's design does about it: two launches.
// - The stage pass (k7s_stage_kernel, stage_pass) runs a thread per (stage,
//   lane) and a terminal row: it forms x_g, x_{g+1} and u_g as xa + a dx
//   (candidate, in registers; the candidate is never written to device
//   memory), and the stage's three terms (stage_terms: soa_rk4, half_quad,
//   barrier_value), written to
//   terms [3N + 1, B]: 1/2 tp, phi_x, phi_u at rows 3g .. 3g + 2, the
//   terminal 1/2 e_N' Qf e_N at row 3N (64 MB at B=131072).
// - The reduction (k7s_reduce_kernel, reduce) runs a thread per lane and
//   adds the terms in stage order, as one thread walking its scenario's
//   stages would: th = 1/2 tp_0, then th + 1/2 tp_g; ph = phi_x_0 +
//   phi_u_0, then (ph + phi_x_g) + phi_u_g; the terminal term last.
// It takes any N >= 1. Global arrays are indexed ((stage * 12 + row) * B +
// lane), so consecutive threads read consecutive addresses. Constants
// (model, Ac, bc, R, Q, Qf) sit in shared memory. Built with -fmad=false, so
// it rounds like the plain version.
//
// K7b evaluates the same sums at the iterate itself (x, u) and adds the
// diagnostics max|defect| (seeded 0) and min constraint (seeded 1e30), each
// taken over a stage's rows and then over the stages, NaN-propagating. With
// GRAD it also writes the running-stage gradients Jx[g] = Q e_g and
// Ju[g] = Ac' db_g + R u_g, coalesced at ((g * 12 + row) * B + lane); the
// wrapper adds the terminal row Jx[N] = Qf e_N. It moves ~3.0 KB per scenario
// without gradients (x, u, x_ref) and ~4.9 KB with them, and is bound, like
// K7a, by the RK4 chain's arithmetic and those bytes. A TPU grid axis over the
// stages (with the sums carried in scratch) becomes the thread's stage loop.

#include "srbd_dev.cuh"

namespace k7 {

using namespace srbd_dev;

// constants block (offsets match models/merit_kernel.py::_K_*): mass, dt,
// Iinv[9], foot[6], then Ac [24,12], bc [24], R, Q, Qf [12,12]
constexpr int K_AC = 17, K_BC = 305, K_R = 329, K_Q = 473, K_QF = 617, K_LEN = 761;

// 1/2 v' M v with M row-major, as 0.5 * sum_i v_i (sum_k M_ik v_k)
template <typename T>
HD T half_quad(const T* M, const T* v) {
  T s = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = M[12 * i] * v[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) acc = acc + M[12 * i + k] * v[k];
    s = (i == 0) ? v[0] * acc : s + v[i] * acc;
  }
  return T(0.5) * s;
}

// x_g of the candidate: xa + a dx (u_g alike from us, du)
template <typename T>
HD void candidate(const T* xa, const T* dx, T a, int g, int B, int b, T* out) {
#pragma unroll
  for (int i = 0; i < 12; ++i)
    out[i] = xa[((size_t)g * 12 + i) * B + b] + a * dx[((size_t)g * 12 + i) * B + b];
}

// a stage's terms at the candidate: tp = |x_{g+1} - rk4(x_g, u_g)|^2 (theta
// adds 1/2 tp), phi_x = 1/2 e'Qe and phi_u = the barrier's sum + 1/2 u'Ru
template <typename T>
HD void stage_terms(const Model<T>& md, const T* kc, const T* x, const T* xn,
                    const T* u, const T* e, T mu_b, T theta_b, T log_th, T& tp,
                    T& phi_x, T& phi_u) {
  const T* Ac = kc + K_AC;
  const T* bc = kc + K_BC;
  T fx[12];
  soa_rk4(md, x, u, fx);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const T d = xn[i] - fx[i];
    tp = (i == 0) ? d * d : tp + d * d;
  }
  phi_x = half_quad(kc + K_Q, e);

  T sbar = 0;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    T con = Ac[12 * r] * u[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) con = con + Ac[12 * r + k] * u[k];
    con = con + bc[r];
    const T bb = barrier_value(con, mu_b, theta_b, log_th);
    sbar = (r == 0) ? bb : sbar + bb;
  }
  phi_u = sbar + half_quad(kc + K_R, u);
}

// K7a, pass 1 (k7s_stage_kernel): the terms of stage g < N at
// rows 3g .. 3g + 2 of terms [3N + 1, B] (1/2 tp, phi_x, phi_u), or for
// g == N the terminal 1/2 e_N' Qf e_N at row 3N
template <typename T>
HD void stage_pass(const T* kc, const T* xa, const T* dx, const T* us, const T* du,
                   const T* xr, const T* alpha, T* terms, int N, int B, int g, int b,
                   T mu_b, T theta_b) {
#define V12(ptr, g, row) (ptr)[((size_t)(g) * 12 + (row)) * B + b]
#define TERM(row) terms[(size_t)(row) * B + b]
  const T a = alpha[b];
  T x[12], e[12];
  candidate(xa, dx, a, g, B, b, x);
#pragma unroll
  for (int i = 0; i < 12; ++i) e[i] = x[i] - V12(xr, g, i);
  if (g == N) {
    TERM(3 * N) = half_quad(kc + K_QF, e);
    return;
  }
  const Model<T> md = load_model(kc);
  T xn[12], u[12];
  candidate(xa, dx, a, g + 1, B, b, xn);
  candidate(us, du, a, g, B, b, u);
  T tp, phi_x, phi_u;
  stage_terms(md, kc, x, xn, u, e, mu_b, theta_b, k_log(theta_b), tp, phi_x, phi_u);
  TERM(3 * g) = T(0.5) * tp;
  TERM(3 * g + 1) = phi_x;
  TERM(3 * g + 2) = phi_u;
#undef TERM
#undef V12
}

// pass 2 (k7s_reduce_kernel): theta and phi of one lane from its terms, in
// stage order (th = 1/2 tp_0, then th + 1/2 tp_g;
// ph = phi_x_0 + phi_u_0, then (ph + phi_x_g) + phi_u_g; the terminal last)
template <typename T>
HD void reduce(const T* terms, T* theta_out, T* phi_out, int N, int B, int b) {
#define TERM(row) terms[(size_t)(row) * B + b]
  T th = 0, ph = 0;
  for (int g = 0; g < N; ++g) {
    th = (g == 0) ? TERM(3 * g) : th + TERM(3 * g);
    ph = ((g == 0) ? TERM(3 * g + 1) : ph + TERM(3 * g + 1)) + TERM(3 * g + 2);
  }
  theta_out[b] = th;
  phi_out[b] = ph + TERM(3 * N);
#undef TERM
}

// y = M v with M row-major [12, 12], each row summed left to right
template <typename T>
HD void mat_vec12(const T* M, const T* v, T* y) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = M[12 * i] * v[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) acc = acc + M[12 * i + k] * v[k];
    y[i] = acc;
  }
}

// 1/2 v' w, summed left to right (half_quad with w = M v given)
template <typename T>
HD T half_dot12(const T* v, const T* w) {
  T s = v[0] * w[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) s = s + v[i] * w[i];
  return T(0.5) * s;
}

// K7b: out [4, B] = theta, phi, max|defect|, min constraint; with GRAD the
// running-stage rows of Jx [N+1, 12, B] and Ju [N, 12, B]
template <typename T, bool GRAD>
HD void merit_scenario(const T* kc, const T* xa, const T* us, const T* xr, T* out,
                       T* Jx, T* Ju, int N, int B, int b, T mu_b, T theta_b) {
#define V12(ptr, g, row) (ptr)[((size_t)(g) * 12 + (row)) * B + b]
  const Model<T> md = load_model(kc);
  const T* Ac = kc + K_AC;
  const T* bc = kc + K_BC;
  const T log_th = k_log(theta_b);

  T x[12], xn[12], u[12], e[12], fx[12], qx[12], ru[12], db[24];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = V12(xa, 0, i);
  T th = 0, ph = 0, mdef = 0, mcon = T(1e30);
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      xn[i] = V12(xa, g + 1, i);
      u[i] = V12(us, g, i);
      e[i] = x[i] - V12(xr, g, i);
    }
    soa_rk4(md, x, u, fx);
    T tp = 0, mb = 0;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const T d = xn[i] - fx[i];
      const T ad = d < 0 ? -d : d;
      tp = (i == 0) ? d * d : tp + d * d;
      mb = (i == 0) ? ad : nan_max(mb, ad);
    }
    mat_vec12(kc + K_Q, e, qx);
    const T phi_x = half_dot12(e, qx);

    T sbar = 0, mc = 0;
#pragma unroll
    for (int r = 0; r < 24; ++r) {
      T con = Ac[12 * r] * u[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) con = con + Ac[12 * r + k] * u[k];
      con = con + bc[r];
      T bb;
      if (GRAD) {
        barrier_grad(con, mu_b, theta_b, log_th, bb, db[r]);
      } else {
        bb = barrier_value(con, mu_b, theta_b, log_th);
      }
      sbar = (r == 0) ? bb : sbar + bb;
      mc = (r == 0) ? con : nan_min(mc, con);
    }
    mat_vec12(kc + K_R, u, ru);
    const T phi_u = sbar + half_dot12(u, ru);

    th = (g == 0) ? T(0.5) * tp : th + T(0.5) * tp;
    ph = ((g == 0) ? phi_x : ph + phi_x) + phi_u;
    mdef = nan_max(mdef, mb);
    mcon = nan_min(mcon, mc);
    if (GRAD) {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        T acc = Ac[i] * db[0];
#pragma unroll
        for (int r = 1; r < 24; ++r) acc = acc + Ac[12 * r + i] * db[r];
        V12(Jx, g, i) = qx[i];
        V12(Ju, g, i) = acc + ru[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) x[i] = xn[i];
  }
  // terminal: x holds x_N
#pragma unroll
  for (int i = 0; i < 12; ++i) e[i] = x[i] - V12(xr, N, i);
  out[b] = th;
  out[B + b] = ph + half_quad(kc + K_QF, e);
  out[2 * B + b] = mdef;
  out[3 * B + b] = mcon;
#undef V12
}

}  // namespace k7

#ifdef __CUDACC__

// K7a, pass 1: a thread per (stage blockIdx.y <= N, lane)
__global__ void k7s_stage_kernel(const float* __restrict__ consts, const float* xa,
                                 const float* dx, const float* us, const float* du,
                                 const float* xr, const float* alpha, float* terms, int N,
                                 int B, float mu_b, float theta_b) {
  __shared__ float kc[k7::K_LEN];
  for (int i = threadIdx.x; i < k7::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k7::stage_pass<float>(kc, xa, dx, us, du, xr, alpha, terms, N, B, blockIdx.y, lane,
                        mu_b, theta_b);
}

// K7a, pass 2: a thread per lane
__global__ void k7s_reduce_kernel(const float* terms, float* theta, float* phi, int N,
                                  int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k7::reduce<float>(terms, theta, phi, N, B, lane);
}

// the stage pass and the reduction through terms [3N + 1, B]. Each launch's
// error is returned as it is made.
extern "C" int srbd_merit_alpha_launch(const float* consts, const float* xa,
                                       const float* dx, const float* us, const float* du,
                                       const float* xr, const float* alpha, float* theta,
                                       float* phi, float* terms, int N, int B, float mu_b,
                                       float theta_b, int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (B + threads - 1) / threads;
  k7s_stage_kernel<<<dim3(blocks, N + 1), threads, 0, s>>>(
      consts, xa, dx, us, du, xr, alpha, terms, N, B, mu_b, theta_b);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k7s_reduce_kernel<<<blocks, threads, 0, s>>>(terms, theta, phi, N, B);
  return (int)cudaGetLastError();
}

template <bool GRAD>
__global__ void merit_kernel(const float* __restrict__ consts, const float* xa,
                             const float* us, const float* xr, float* out, float* Jx,
                             float* Ju, int N, int B, float mu_b, float theta_b) {
  __shared__ float kc[k7::K_LEN];
  for (int i = threadIdx.x; i < k7::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k7::merit_scenario<float, GRAD>(kc, xa, us, xr, out, Jx, Ju, N, B, lane, mu_b,
                                  theta_b);
}

// grad != 0: the variant with gradients (Jx, Ju written); else Jx, Ju unused
extern "C" int srbd_merit_launch(const float* consts, const float* xa, const float* us,
                                 const float* xr, float* out, float* Jx, float* Ju, int N,
                                 int B, float mu_b, float theta_b, int grad, int threads,
                                 void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  if (grad)
    merit_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, out, Jx, Ju, N, B, mu_b, theta_b);
  else
    merit_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, out, Jx, Ju, N, B, mu_b, theta_b);
  return (int)cudaGetLastError();
}

#else  // host builds: the same per-lane bodies over every lane

#include <vector>

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

// K7a: the stage pass over every (stage <= N, lane), then the reduction of
// every lane
extern "C" int srbd_merit_alpha_split_host(const host_t* consts, const host_t* xa,
                                           const host_t* dx, const host_t* us,
                                           const host_t* du, const host_t* xr,
                                           const host_t* alpha, host_t* theta,
                                           host_t* phi, int N, int B, double mu_b,
                                           double theta_b) {
  std::vector<host_t> terms((size_t)(3 * N + 1) * B);
  for (int g = 0; g <= N; ++g)
    for (int lane = 0; lane < B; ++lane)
      k7::stage_pass<host_t>(consts, xa, dx, us, du, xr, alpha, terms.data(), N, B, g,
                             lane, mu_b, theta_b);
  for (int lane = 0; lane < B; ++lane)
    k7::reduce<host_t>(terms.data(), theta, phi, N, B, lane);
  return 0;
}

extern "C" int srbd_merit_host_f64(const host_t* consts, const host_t* xa, const host_t* us,
                                   const host_t* xr, host_t* out, host_t* Jx, host_t* Ju,
                                   int N, int B, double mu_b, double theta_b, int grad) {
  for (int lane = 0; lane < B; ++lane) {
    if (grad)
      k7::merit_scenario<host_t, true>(consts, xa, us, xr, out, Jx, Ju, N, B, lane, mu_b,
                                       theta_b);
    else
      k7::merit_scenario<host_t, false>(consts, xa, us, xr, out, Jx, Ju, N, B, lane,
                                        mu_b, theta_b);
  }
  return 0;
}

#endif
