// K5 · stage linearization, one thread per (stage, scenario).
//
// Replaces the TPU kernel srbd_nmpc_tpu/models/srbd_pallas.py::_kernel (through
// linearize_pallas). Contract: the plain PyTorch version
// srbd_nmpc_tpu_torch/models/srbd_linearize.py::linearize_ref.
//
// Per (stage g, scenario b): the Euler sensitivities A = I + dt J_fx and
// B = dt J_fu from the SO(3) Jacobian chain, the shooting defect
// b = rk4(x, u) - x_next (four dynamics calls, srbd_soa.rk4), the relaxed
// barrier of the 24 friction-cone rows folded into R_eff = R + Ac' diag(ddb) Ac
// and r_eff = R u + Ac' db, the tracking gradient q = Q (x - x_ref), and eight
// merit partials [1/2 sum b^2, sum barrier, min con, max |b|, 1/2 u'Ru,
// 1/2 ex'q, 0, 0].
//
// What bounds it on the H100: writing the three dense [N,12,12,B] outputs
// (A, B, R_eff: 1,728 bytes per stage and scenario in f32, structural zeros
// included, as the contract asks), and the transcendental-heavy SO(3) chain
// (five chain evaluations per thread). Stages are independent, so the grid
// covers (ceil(B / threads), N) and every output is written once, coalesced:
// index ((g * rows + row) * B + b), consecutive threads on consecutive lanes.
// Constants (model, Ac, bc, R, Q) sit in shared memory. Sums keep the plain
// version's order and the build uses -fmad=false, so the kernel rounds like
// the plain version.

#include "srbd_dev.cuh"

namespace k5 {

using namespace srbd_dev;

// constants block (offsets match models/srbd_linearize.py::_K_*): mass, dt,
// Iinv[9], foot[6], then Ac [24,12], bc [24], R [12,12], Q [12,12]
constexpr int K_AC = 17, K_BC = 305, K_R = 329, K_Q = 473, K_LEN = 617;

template <typename T>
HD void stage(const T* kc, const T* xs, const T* xn, const T* us, const T* xr, T* Ao,
              T* Bo, T* bo, T* Reffo, T* reffo, T* qo, T* mer, int B, int g, int b,
              T mu_b, T theta_b) {
#define V12(ptr, row) (ptr)[((size_t)g * 12 + (row)) * B + b]
#define M12(ptr, i, j) (ptr)[(((size_t)g * 12 + (i)) * 12 + (j)) * B + b]
  const Model<T> md = load_model(kc);
  const T* Ac = kc + K_AC;
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;

  T x[12], xnx[12], u[12], ex[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = V12(xs, i);
    xnx[i] = V12(xn, i);
    u[i] = V12(us, i);
    ex[i] = x[i] - V12(xr, i);
  }

  // ---- Euler sensitivities -------------------------------------------------
  M3<T> D1, D2;
  T sF[3], sr[3], sl[3];
  soa_jacobian_blocks(md, x, u, D1, D2, sF, sr, sl);
  const T dt = md.dt;
  const T inv_m = T(1) / md.mass;
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      M12(Ao, i, j) = T(i == j ? 1 : 0) + dt * jfx(D1, D2, sF, i, j);
      M12(Bo, i, j) = dt * jfu(sr, sl, inv_m, i, j);
    }

  // ---- shooting defect ---------------------------------------------------
  T bv[12];
  soa_rk4(md, x, u, bv);
  T th = 0, md_ = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    bv[i] = bv[i] - xnx[i];
    V12(bo, i) = bv[i];
    th = (i == 0) ? bv[0] * bv[0] : th + bv[i] * bv[i];
    const T ab = bv[i] < 0 ? -bv[i] : bv[i];
    md_ = (i == 0) ? ab : (ab > md_ || ab != ab ? ab : md_);
  }

  // ---- constraints, barrier, R_eff, r_eff ---------------------------------
  const T log_th = k_log(theta_b);
  T db[24], ddb[24], sbar = 0, mincon = 0;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    T con = Ac[12 * r] * u[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) con = con + Ac[12 * r + k] * u[k];
    con = con + bc[r];
    mincon = (r == 0) ? con : (con < mincon || con != con ? con : mincon);
    T bb;
    barrier(con, mu_b, theta_b, log_th, bb, db[r], ddb[r]);
    sbar = (r == 0) ? bb : sbar + bb;
  }
  T uRu = 0, eq = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T acc = Ac[i] * (Ac[j] * ddb[0]);
#pragma unroll
      for (int r = 1; r < 24; ++r) acc = acc + Ac[12 * r + i] * (Ac[12 * r + j] * ddb[r]);
      M12(Reffo, i, j) = Rw[12 * i + j] + acc;
    }
    T ru = Rw[12 * i] * u[0];
    T qi = Qw[12 * i] * ex[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) {
      ru = ru + Rw[12 * i + k] * u[k];
      qi = qi + Qw[12 * i + k] * ex[k];
    }
    T ad = Ac[i] * db[0];
#pragma unroll
    for (int r = 1; r < 24; ++r) ad = ad + Ac[12 * r + i] * db[r];
    V12(reffo, i) = ru + ad;
    V12(qo, i) = qi;
    uRu = (i == 0) ? u[0] * ru : uRu + u[i] * ru;
    eq = (i == 0) ? ex[0] * qi : eq + ex[i] * qi;
  }

#define MER(row) mer[((size_t)g * 8 + (row)) * B + b]
  MER(0) = T(0.5) * th;
  MER(1) = sbar;
  MER(2) = mincon;
  MER(3) = md_;
  MER(4) = T(0.5) * uRu;
  MER(5) = T(0.5) * eq;
  MER(6) = T(0);
  MER(7) = T(0);
#undef MER
#undef M12
#undef V12
}

}  // namespace k5

#ifdef __CUDACC__

__global__ void linearize_kernel(const float* __restrict__ consts, const float* xs,
                                 const float* xn, const float* us, const float* xr,
                                 float* A, float* Bm, float* b, float* Reff, float* reff,
                                 float* q, float* mer, int B, float mu_b, float theta_b) {
  __shared__ float kc[k5::K_LEN];
  for (int i = threadIdx.x; i < k5::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k5::stage<float>(kc, xs, xn, us, xr, A, Bm, b, Reff, reff, q, mer, B, blockIdx.y, lane,
                   mu_b, theta_b);
}

extern "C" int srbd_linearize_launch(const float* consts, const float* xs, const float* xn,
                                     const float* us, const float* xr, float* A, float* Bm,
                                     float* b, float* Reff, float* reff, float* q,
                                     float* mer, int N, int B, float mu_b, float theta_b,
                                     int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((B + threads - 1) / threads, N);
  linearize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      consts, xs, xn, us, xr, A, Bm, b, Reff, reff, q, mer, B, mu_b, theta_b);
  return (int)cudaGetLastError();
}

#else  // host build: the same per-thread body over every (stage, lane), in f64

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

extern "C" int srbd_linearize_host_f64(const host_t* consts, const host_t* xs,
                                       const host_t* xn, const host_t* us,
                                       const host_t* xr, host_t* A, host_t* Bm, host_t* b,
                                       host_t* Reff, host_t* reff, host_t* q, host_t* mer,
                                       int N, int B, double mu_b, double theta_b) {
  for (int g = 0; g < N; ++g)
    for (int lane = 0; lane < B; ++lane)
      k5::stage<host_t>(consts, xs, xn, us, xr, A, Bm, b, Reff, reff, q, mer, B, g, lane,
                        mu_b, theta_b);
  return 0;
}

#endif
