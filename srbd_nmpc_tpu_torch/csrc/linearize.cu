// K5 · stage linearization: stage passes and a block-written dense A, B, R_eff.
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
// included, as the contract asks; 5.5 GB a call at N=20, B=131072, 1.64 ms
// at 3.35 TB/s). In one thread per (stage, lane) that forms all 432 entries
// beside the chain, the chain's state and the fully unrolled R_eff sums are
// live together: 255 registers, ~5 KB of spill stores per thread, more
// local-memory traffic than output (PERF.md).
//
// What this design does about it: the dense matrices leave the stage's
// thread.
// - The stage pass (k5::stage_pass, one thread per (stage, lane)) runs the
//   stage code (load_stage, stage_vectors: the RK4
//   defect, the constraint rows and barrier, r_eff, q), writes b, q, r_eff
//   and the merit partials (44 words) and hands on ddb (24 words), each
//   word as it is formed (Ac' db is summed row by row as the rows come).
// - The dense write forms each entry of one lane with the plain version's
//   expression: A = (i == j) + dt J_fx(i, j) from the Jacobian blocks
//   (k5::dense_a runs soa_jacobian_blocks itself, from x and u), B =
//   dt J_fu(i, j) from the lever arms (k5::dense_b), and R_eff = R(i, j) +
//   the sum over r = 0..23, in order, of Ac(r, i) (Ac(r, j) ddb(r))
//   (k5::dense_r); all 144 R_eff entries, no zero term of Ac skipped (a NaN
//   reaches R_eff as in the plain version). A warp covers one entry for 32
//   consecutive lanes, so each store is a full 128-byte line at
//   ((g * 12 + i) * 12 + j) * B + lane. R_eff is formed six rows at a time:
//   the 24 terms of each entry are added in r order into that entry's own
//   sum, and each product Ac(r, j) ddb(r) is formed once for the six rows.
//   Measured on the H100, the Jacobian chain beside the RK4 defect in the
//   stage pass's thread cost several times what it costs alone, so the
//   chain moved to the dense write of A and the hand-off shrank to ddb.
// Two launches (k5s_stage_kernel, then k5s_dense_kernel): the hand-off goes
// through a [N, 24, B] scratch and the dense write reads x and u again (0.7
// GB more bytes at B=131072); the dense write runs a block per 128 lanes,
// stage and matrix, the three matrices alternating along the grid, with few
// registers. (A one-launch form, the hand-off in shared memory and the dense
// write in the stage pass's threads, measured slower on the H100 at every
// width: PERF.md.)
// No operation crosses scenarios. Constants (model, Ac, bc, R, Q) sit in
// shared memory. Sums keep the plain version's order and the build uses
// -fmad=false, so the two launches round like the plain version.
//
// The per-lane bodies compile as host C++ (without __CUDACC__): the host
// entry runs the two launches over every (stage, lane), so that tests hold
// it to the plain version (f64) and its f32 build (-DSRBD_HOST_F32) to
// stored digests of its outputs without a card.

#include "srbd_dev.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

namespace k5 {

using namespace srbd_dev;

// constants block (offsets match models/srbd_linearize.py::_K_*): mass, dt,
// Iinv[9], foot[6], then Ac [24,12], bc [24], R [12,12], Q [12,12]
constexpr int K_AC = 17, K_BC = 305, K_R = 329, K_Q = 473, K_LEN = 617;
// the words the stage pass hands to the dense write: ddb, one per constraint
// row
constexpr int H_C = 24;
// lanes of a block
constexpr int LANES = 128;

#define V12(ptr, row) (ptr)[((size_t)g * 12 + (row)) * B + b]
#define M12(ptr, i, j) (ptr)[(((size_t)g * 12 + (i)) * 12 + (j)) * B + b]

template <typename T>
HD void load_stage(const T* xs, const T* xn, const T* us, const T* xr, int B, int g,
                   int b, T* x, T* xnx, T* u, T* ex) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = V12(xs, i);
    xnx[i] = V12(xn, i);
    u[i] = V12(us, i);
    ex[i] = x[i] - V12(xr, i);
  }
}

template <typename T>
HD T a_entry(const M3<T>& D1, const M3<T>& D2, const T* sF, T dt, int i, int j) {
  return T(i == j ? 1 : 0) + dt * jfx(D1, D2, sF, i, j);
}

template <typename T>
HD T b_entry(const T* sr, const T* sl, T inv_m, T dt, int i, int j) {
  return dt * jfu(sr, sl, inv_m, i, j);
}

// everything of the stage but A, B and R_eff: the shooting defect b, r_eff,
// q and the merit partials are written, and ddb at ddb[r * ds] as each
// constraint row is evaluated. Ac' db is summed row by row as the rows come
// (r in order, as the plain version), so no db is kept.
template <typename T>
HD void stage_vectors(const Model<T>& md, const T* kc, const T* x, const T* xnx,
                      const T* u, const T* ex, T* bo, T* reffo, T* qo, T* mer, int B,
                      int g, int b, T mu_b, T theta_b, T* ddb, size_t ds) {
  const T* Ac = kc + K_AC;
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;

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

  // ---- constraints, barrier, r_eff, q -------------------------------------
  const T log_th = k_log(theta_b);
  T ad[12], sbar = 0, mincon = 0;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    T con = Ac[12 * r] * u[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) con = con + Ac[12 * r + k] * u[k];
    con = con + bc[r];
    mincon = (r == 0) ? con : (con < mincon || con != con ? con : mincon);
    T bb, db, dd;
    barrier(con, mu_b, theta_b, log_th, bb, db, dd);
    ddb[r * ds] = dd;
    sbar = (r == 0) ? bb : sbar + bb;
#pragma unroll
    for (int i = 0; i < 12; ++i)
      ad[i] = (r == 0) ? Ac[i] * db : ad[i] + Ac[12 * r + i] * db;
  }
  T uRu = 0, eq = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T ru = Rw[12 * i] * u[0];
    T qi = Qw[12 * i] * ex[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) {
      ru = ru + Rw[12 * i + k] * u[k];
      qi = qi + Qw[12 * i + k] * ex[k];
    }
    V12(reffo, i) = ru + ad[i];
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
}

// ---------------------------------------------------------------------------
// The stage pass with its hand-off at h[r * hs], and the dense write of
// each matrix
// ---------------------------------------------------------------------------
template <typename T>
HD void stage_pass(const T* kc, const T* xs, const T* xn, const T* us, const T* xr,
                   T* bo, T* reffo, T* qo, T* mer, int B, int g, int b, T mu_b,
                   T theta_b, T* h, size_t hs) {
  const Model<T> md = load_model(kc);
  T x[12], xnx[12], u[12], ex[12];
  load_stage(xs, xn, us, xr, B, g, b, x, xnx, u, ex);
  stage_vectors(md, kc, x, xnx, u, ex, bo, reffo, qo, mer, B, g, b, mu_b, theta_b, h,
                hs);
}

// A of lane b at stage g: the Jacobian blocks from x and u, then each entry
template <typename T>
HD void dense_a(const Model<T>& md, const T* xs, const T* us, T* Ao, int B, int g,
                int b) {
  T x[12], u[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = V12(xs, i);
    u[i] = V12(us, i);
  }
  M3<T> D1, D2;
  T sF[3], sr[3], sl[3];
  soa_jacobian_blocks(md, x, u, D1, D2, sF, sr, sl);
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) M12(Ao, i, j) = a_entry(D1, D2, sF, md.dt, i, j);
}

// B of lane b at stage g, from the lever arms sr and sl, formed from x's
// position rows as soa_jacobian_blocks forms them
template <typename T>
HD void dense_b(const Model<T>& md, const T* xs, T* Bo, int B, int g, int b) {
  T sr[3], sl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T p = V12(xs, 6 + i);
    sr[i] = md.pf0[i] - p;
    sl[i] = md.pf1[i] - p;
  }
  const T inv_m = T(1) / md.mass;
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) M12(Bo, i, j) = b_entry(sr, sl, inv_m, md.dt, i, j);
}

// R_eff R_G rows at a time: entry (i, j) is R(i, j) + acc(i, j), acc(i, j)
// summing Ac(r, i) (Ac(r, j) ddb(r)) over r = 0..23 in order. The product Ac(r, j) ddb(r) is formed once for the R_G
// rows of a group (it is the same number in each). Neither the loop over
// the groups nor the one over r is unrolled, and ddb(r) is read from the
// hand-off at each step: unrolled, the 288 products, the same for every
// row, are hoisted out of the row loop and spill.
constexpr int R_G = 6;

template <typename T>
HD void dense_r(const T* Ac, const T* Rw, const T* h, size_t hs, T* Ro, int B, int g,
                int b) {
#pragma unroll 1
  for (int i0 = 0; i0 < 12; i0 += R_G) {
    T acc[R_G][12], w[12];
    const T d0 = h[0];
#pragma unroll
    for (int j = 0; j < 12; ++j) w[j] = Ac[j] * d0;
#pragma unroll
    for (int k = 0; k < R_G; ++k)
#pragma unroll
      for (int j = 0; j < 12; ++j) acc[k][j] = Ac[i0 + k] * w[j];
#pragma unroll 1
    for (int r = 1; r < 24; ++r) {
      const T d = h[r * hs];
#pragma unroll
      for (int j = 0; j < 12; ++j) w[j] = Ac[12 * r + j] * d;
#pragma unroll
      for (int k = 0; k < R_G; ++k) {
        const T c = Ac[12 * r + i0 + k];
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[k][j] = acc[k][j] + c * w[j];
      }
    }
#pragma unroll
    for (int k = 0; k < R_G; ++k)
#pragma unroll
      for (int j = 0; j < 12; ++j)
        M12(Ro, i0 + k, j) = Rw[12 * (i0 + k) + j] + acc[k][j];
  }
}

#undef M12
#undef V12

}  // namespace k5

#ifdef __CUDACC__

// Ac [24,12] then R [12,12] of the constants block, 16-byte aligned in
// shared memory for the dense write of R_eff
__device__ __forceinline__ void load_ac_r(const float* consts, float* ar) {
  for (int i = threadIdx.x; i < 288 + 144; i += blockDim.x)
    ar[i] = consts[i < 288 ? k5::K_AC + i : k5::K_R + i - 288];
}

// launch 1: the stage pass into the [N, 24, B] hand-off
__global__ void __launch_bounds__(k5::LANES, 3)
    k5s_stage_kernel(const float* __restrict__ consts, const float* xs, const float* xn,
                     const float* us, const float* xr, float* b, float* reff, float* q,
                     float* mer, float* hand, int B, float mu_b, float theta_b) {
  __shared__ float kc[k5::K_LEN];
  for (int i = threadIdx.x; i < k5::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int g = blockIdx.y;
  k5::stage_pass<float>(kc, xs, xn, us, xr, b, reff, q, mer, B, g, lane, mu_b, theta_b,
                        hand + (size_t)g * k5::H_C * B + lane, B);
}

// launch 2: the dense write of one matrix (blockIdx.x % 3: A, B, R_eff) of
// the block's 128 lanes (blockIdx.x / 3) at stage blockIdx.y. The three
// matrices alternate along the grid, so that the blocks an SM holds mix the
// store-bound A and B with the arithmetic of R_eff.
__global__ void __launch_bounds__(k5::LANES, 4)
    k5s_dense_kernel(const float* __restrict__ consts, const float* xs, const float* us,
                     const float* hand, float* A, float* Bm, float* Reff, int B) {
  __shared__ float kc[17];
  __shared__ __align__(16) float ar[288 + 144];
  const int z = blockIdx.x % 3;
  if (z == 2)
    load_ac_r(consts, ar);
  else
    for (int i = threadIdx.x; i < 17; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int lane = (blockIdx.x / 3) * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int g = blockIdx.y;
  if (z == 0)
    k5::dense_a<float>(k5::load_model(kc), xs, us, A, B, g, lane);
  else if (z == 1)
    k5::dense_b<float>(k5::load_model(kc), xs, Bm, B, g, lane);
  else
    k5::dense_r<float>(ar, ar + 288, hand + (size_t)g * k5::H_C * B + lane, B, Reff, B,
                       g, lane);
}

// the stage pass and the dense write through `hand` [N, 24, B]. Each
// launch's error is returned as it is made.
extern "C" int srbd_linearize_launch(const float* consts, const float* xs, const float* xn,
                                     const float* us, const float* xr, float* A, float* Bm,
                                     float* b, float* Reff, float* reff, float* q,
                                     float* mer, float* hand, int N, int B, float mu_b,
                                     float theta_b, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + k5::LANES - 1) / k5::LANES, N);
  k5s_stage_kernel<<<grid, k5::LANES, 0, s>>>(consts, xs, xn, us, xr, b, reff, q, mer,
                                              hand, B, mu_b, theta_b);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid3(3 * grid.x, N);
  k5s_dense_kernel<<<grid3, k5::LANES, 0, s>>>(consts, xs, us, hand, A, Bm, Reff, B);
  return (int)cudaGetLastError();
}

#else  // host builds: the same per-lane bodies over every (stage, lane)

using srbd_dev::host_t;  // double, float, or the op counter under -DSRBD_OPCOUNT

// the stage pass over every (stage, lane) into a [N, 24, B] hand-off, then
// the dense write of each matrix
extern "C" int srbd_linearize_split_host(const host_t* consts, const host_t* xs,
                                         const host_t* xn, const host_t* us,
                                         const host_t* xr, host_t* A, host_t* Bm,
                                         host_t* b, host_t* Reff, host_t* reff, host_t* q,
                                         host_t* mer, int N, int B, double mu_b,
                                         double theta_b) {
  const host_t* Ac = consts + k5::K_AC;
  const host_t* Rw = consts + k5::K_R;
  const k5::Model<host_t> md = k5::load_model(consts);
  std::vector<host_t> hand((size_t)N * k5::H_C * B);
  for (int g = 0; g < N; ++g)
    for (int lane = 0; lane < B; ++lane)
      k5::stage_pass<host_t>(consts, xs, xn, us, xr, b, reff, q, mer, B, g, lane, mu_b,
                             theta_b, &hand[(size_t)g * k5::H_C * B + lane], B);
  for (int z = 0; z < 3; ++z)
    for (int g = 0; g < N; ++g)
      for (int lane = 0; lane < B; ++lane) {
        if (z == 0)
          k5::dense_a<host_t>(md, xs, us, A, B, g, lane);
        else if (z == 1)
          k5::dense_b<host_t>(md, xs, Bm, B, g, lane);
        else
          k5::dense_r<host_t>(Ac, Rw, &hand[(size_t)g * k5::H_C * B + lane], B, Reff, B,
                              g, lane);
      }
  return 0;
}

#endif
