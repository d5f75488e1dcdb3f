// K3a / K3b · one-pass fused SQP trip (dense layout), one thread per scenario.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/sqp_pallas.py::_onepass_cand_kernel
// (K3a, through sqp_qp_solve_onepass_cand: the trip at the line-search candidate
// x + alpha dx, u + alpha du with a per-scenario alpha) and ::_onepass_kernel
// (K3b, through sqp_qp_solve_onepass: the trip at the iterate itself). The two
// TPU kernels are deliberate near-duplicates; here they are one template on a
// compile-time CAND. Contract: the plain PyTorch versions
// srbd_nmpc_tpu_torch/ops/sqp_kernel.py::sqp_qp_solve_onepass_cand_ref and
// ::sqp_qp_solve_onepass_ref. The dense route runs K3 as the three launches
// of sqp_onepass_split.cu, which call this body's stage code (terminal_stage,
// stage_terms, closed_loop_column) and round as it does; this one-launch body
// stays as the yardstick that the card tests and chip_smoke.py hold the split
// kernels to (ops/sqp_kernel.py::_k3a_cuda / _k3b_cuda with one_thread).
//
// Per scenario, stages k = N-1 ... 0 in one backward sweep: linearize the stage
// (srbd_soa.jacobian_blocks and the four-call srbd_soa.rk4, K5's evaluation
// order, not K1's shared chain), the relaxed barrier of the leg-block-diagonal
// friction-cone rows, one structured Riccati stage (shared with K1), the
// closed-loop products Acl = A + B K and bcl = b + B kv, and the merit at the
// current point, accumulated in backward stage order. Then the rollout
// dx_{k+1} = Acl dx_k + bcl, du_k = K dx_k + kv, and dphi. The TPU kernel's
// `fold` (rollout as the epilogue of the last backward grid step, or N more
// grid steps) is the same recursion; there is one loop here.
//
// What bounds it on the H100: like K1, the per-scenario recursion keeps P, the
// Cholesky factor and the 13-column solve live (past the 255-register cap) and
// is latency- and register-bound per thread. The parked stage products (Acl, K
// [N,12,12,B], bcl, kv, q, r_eff [N,12,B]: 1,344 bytes per stage and scenario)
// are written once by the backward sweep and read once by the rollout, all
// indexed (row * B + lane) so consecutive threads touch consecutive addresses.
// Nothing crosses lanes, so a compacted launch gives bitwise the same per-lane
// result as a full-width one. Spills are accepted here.
//
// Full-precision math only, built with -fmad=false, sums in the plain
// version's order: the kernel rounds like the plain version. The per-scenario
// body also compiles as host C++ (without __CUDACC__) for a CPU check in f64,
// and in f32 (-DSRBD_HOST_F32) as the split kernels' bitwise yardstick.

#include "srbd_dev.cuh"

namespace k3 {

using namespace srbd_dev;

// constants block, K1's layout (offsets match ops/sqp_stage.py::K_*)
constexpr int K_AC1 = 17, K_AC2 = 89, K_BC = 161;
constexpr int K_R = 185, K_Q = 329, K_QF = 473, K_LEN = 617;

// state (or input) rows of stage k, the candidate xa + a dxc under CAND
template <typename T, bool CAND>
HD void load_stage(const T* xa, const T* dxc, T a, int k, int B, int b, T* x) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const size_t at = (size_t)(k * 12 + i) * B + b;
    x[i] = CAND ? xa[at] + a * dxc[at] : xa[at];
  }
}

// the terminal stage: the state xn = x_N (the candidate's under CAND),
// qN = Qf (xn - x_ref,N) and sN = eN'qN, each row sum left to right
template <typename T, bool CAND>
HD void terminal_stage(const T* kc, const T* xa, const T* dxc, const T* xr, T a, int N,
                       int B, int b, T* xn, T* qN, T& sN) {
  const T* Qf = kc + K_QF;
  load_stage<T, CAND>(xa, dxc, a, N, B, b, xn);
  T eN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) eN[i] = xn[i] - xr[(size_t)(N * 12 + i) * B + b];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Qf[12 * i] * eN[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
    qN[i] = acc;
    sN = (i == 0) ? eN[0] * acc : sN + eN[i] * acc;
  }
}

// one stage's terms at (x, u), e = x - x_ref, next state xn: the Jacobian
// blocks (srbd_soa.jacobian_blocks: D1, D2 and the generators sF, sr, sl),
// the defect bv = rk4(x, u) - xn (the four-call srbd_soa.rk4: K5's
// evaluation order, not K1's shared chain), the 24 leg-block-diagonal
// constraint rows con with their relaxed barrier (bb, ddb), Ru = R u,
// q = Q e and r_eff = Ru + Ac' db
template <typename T>
HD void stage_terms(const Model<T>& md, const T* kc, T mu_b, T theta_b, T log_th,
                    const T* x, const T* u, const T* e, const T* xn, M3<T>& D1, M3<T>& D2,
                    T* sF, T* sr, T* sl, T* bv, T* con, T* bb, T* ddb, T* Ru, T* q, T* rf) {
  const T* Ac1 = kc + K_AC1;  // [12, 6]
  const T* Ac2 = kc + K_AC2;
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  soa_jacobian_blocks(md, x, u, D1, D2, sF, sr, sl);
  soa_rk4(md, x, u, bv);
#pragma unroll
  for (int i = 0; i < 12; ++i) bv[i] = bv[i] - xn[i];

  T db[24];
#pragma unroll
  for (int g = 0; g < 24; ++g) {
    const T* arow = (g < 12) ? Ac1 + 6 * g : Ac2 + 6 * (g - 12);
    const T* ug = (g < 12) ? u : u + 6;
    T c = arow[0] * ug[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) c = c + arow[j] * ug[j];
    con[g] = c + bc[g];
    barrier(con[g], mu_b, theta_b, log_th, bb[g], db[g], ddb[g]);
  }

#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T ri = Rw[12 * i] * u[0];
    T qi = Qw[12 * i] * e[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) {
      ri = ri + Rw[12 * i + j] * u[j];
      qi = qi + Qw[12 * i + j] * e[j];
    }
    const T* Ab = (i < 6) ? Ac1 + i : Ac2 + (i - 6);
    const T* dbl = (i < 6) ? db : db + 12;
    T acc = Ab[0] * dbl[0];
#pragma unroll
    for (int g = 1; g < 12; ++g) acc = acc + Ab[6 * g] * dbl[g];
    Ru[i] = ri;
    q[i] = qi;
    rf[i] = ri + acc;
  }
}

// column j of the closed-loop products from column j of [K | kv] (y [12]):
// column j < 12 of Acl = A + B K, or (j == 12) bcl = b + B kv, with
//   A = [I + dt D1, dt D2, 0, 0; 0, I, dt SF, 0; 0, 0, I, dt I; 0, 0, 0, I]
//   B K rows: 0; dt (Sr K0 + K1 + Sl K2 + K3); 0; dt/m (K0 + K2)
// (dtm = dt/m). Structural zeros are returned as zeros, so that a product
// with the column rounds as the dense one does.
template <typename T>
HD void closed_loop_column(const T (&D1)[3][3], const T (&D2)[3][3], const T* sF,
                           const T* sr, const T* sl, const T* bv, const T* y, int j, T dt,
                           T dtm, T* col) {
  const T k0[3] = {y[0], y[1], y[2]};
  const T k2[3] = {y[6], y[7], y[8]};
  T cr[3], cl[3];
  cross3(sr, k0, cr);
  cross3(sl, k2, cl);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T bk = dt * (((cr[i] + y[3 + i]) + cl[i]) + y[9 + i]);
    const T bm = dtm * (y[i] + y[6 + i]);
    if (j == 12) {
      col[i] = bv[i];
      col[3 + i] = bv[3 + i] + bk;
      col[6 + i] = bv[6 + i];
      col[9 + i] = bv[9 + i] + bm;
      continue;
    }
    col[i] = (j < 3) ? T(i == j ? 1 : 0) + dt * D1[i][j] : (j < 6) ? dt * D2[i][j - 3] : T(0);
    const T a3 = (j >= 3 && j < 6) ? T(i == j - 3 ? 1 : 0)
                 : (j >= 6 && j < 9) ? dt * skew_at(sF, i, j - 6) : T(0);
    col[3 + i] = a3 + bk;
    col[6 + i] = (j >= 6 && j < 9) ? T(i == j - 6 ? 1 : 0)
                 : (j >= 9) ? dt * T(i == j - 9 ? 1 : 0) : T(0);
    col[9 + i] = T(j >= 9 && i == j - 9 ? 1 : 0) + bm;
  }
}

template <typename T, bool CAND>
HD void scenario(const T* kc, const T* xa, const T* us, const T* xr, const T* dxc,
                 const T* duc, const T* alpha, const T* dx0, T* dx_out, T* du_out,
                 T* dphi_out, T* theta_out, T* phi_out, T* maxdef_out, T* mincon_out,
                 T* Aclp, T* Kp, T* bclp, T* kvp, T* qp, T* rfp, int N, int B, int b,
                 T mu_b, T theta_b, T reg) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const Model<T> md = load_model(kc);
  const T dt = md.dt;
  const T m_inv = T(1) / md.mass;
  const T dtm = dt * m_inv;
  const T a = CAND ? alpha[b] : T(0);
  const T* Ac1 = kc + K_AC1;
  const T* Ac2 = kc + K_AC2;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T* Qf = kc + K_QF;
  const T log_th = k_log(theta_b);

  // terminal stage: Riccati seed (P, p) = (Qf, qN) and phi_N
  T P[12][12], p[12], qN[12], xn[12], sN;
  terminal_stage<T, CAND>(kc, xa, dxc, xr, a, N, B, b, xn, qN, sN);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    p[i] = qN[i];
#pragma unroll
    for (int j = 0; j < 12; ++j) P[i][j] = Qf[12 * i + j];
  }
  Merit<T> mer = merit_seed(T(0.5) * sN);

  for (int k = N - 1; k >= 0; --k) {
    // ---- stage linearization, constraints, barrier, Ru, q, r_eff ---------
    T x[12], u[12], e[12];
    load_stage<T, CAND>(xa, dxc, a, k, B, b, x);
    load_stage<T, CAND>(us, duc, a, k, B, b, u);
#pragma unroll
    for (int i = 0; i < 12; ++i) e[i] = x[i] - AT(xr, k * 12 + i);
    M3<T> D1, D2;
    T sF[3], sr[3], sl[3], bv[12], con[24], bb[24], ddb[24], Ru[12], q[12], rf[12];
    stage_terms(md, kc, mu_b, theta_b, log_th, x, u, e, xn, D1, D2, sF, sr, sl, bv, con, bb,
                ddb, Ru, q, rf);

    // ---- structured Riccati stage; [K | kv] = -Y --------------------------
    T Y[12][13];
    riccati_stage_structured(D1.m, D2.m, sF, sr, sl, bv, q, rf, ddb, Ac1, Ac2, Rw, Qw,
                             dt, m_inv, reg, P, p, Y);
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int c = 0; c < 13; ++c) Y[i][c] = -Y[i][c];

    // ---- park K, kv, q, r_eff and Acl = A + B K, bcl = b + B kv -----------
#pragma unroll
    for (int j = 0; j < 13; ++j) {
      T y[12], col[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) y[i] = Y[i][j];
      closed_loop_column(D1.m, D2.m, sF, sr, sl, bv, y, j, dt, dtm, col);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (j == 12) AT(bclp, k * 12 + i) = col[i];
        else AT(Aclp, (k * 12 + i) * 12 + j) = col[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j < 12; ++j) AT(Kp, (k * 12 + i) * 12 + j) = Y[i][j];
      AT(kvp, k * 12 + i) = Y[i][12];
      AT(qp, k * 12 + i) = q[i];
      AT(rfp, k * 12 + i) = rf[i];
    }

    // ---- merit at the current point, backward stage order -----------------
    merit_accumulate(mer, bv, con, bb, u, Ru, e, q);
#pragma unroll
    for (int i = 0; i < 12; ++i) xn[i] = x[i];
  }
  AT(theta_out, 0) = mer.th;
  AT(phi_out, 0) = mer.ph;
  AT(maxdef_out, 0) = mer.md;
  AT(mincon_out, 0) = mer.mc;

  // ---- rollout and dphi ----------------------------------------------------
  T dx[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) dx[i] = AT(dx0, i);
  AT(dphi_out, 0) =
      closed_loop_rollout(Aclp, Kp, bclp, kvp, qp, rfp, qN, dx, dx_out, du_out, N, B, b);
#undef AT
}

}  // namespace k3

// K3_NO_ENTRIES: the bodies alone, for a source that includes this one
// (sqp_onepass_split.cu)
#ifndef K3_NO_ENTRIES
#ifdef __CUDACC__

template <bool CAND>
__global__ void sqp_onepass_kernel(const float* __restrict__ consts, const float* xa,
                                   const float* us, const float* xr, const float* dxc,
                                   const float* duc, const float* alpha, const float* dx0,
                                   float* dx_out, float* du_out, float* dphi, float* theta,
                                   float* phi, float* maxdef, float* mincon, float* Acl,
                                   float* K, float* bcl, float* kv, float* q, float* rf,
                                   int N, int B, float mu_b, float theta_b, float reg) {
  __shared__ float kc[k3::K_LEN];
  for (int i = threadIdx.x; i < k3::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k3::scenario<float, CAND>(kc, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi,
                            theta, phi, maxdef, mincon, Acl, K, bcl, kv, q, rf, N, B, b,
                            mu_b, theta_b, reg);
}

// cand != 0: K3a (dxc, duc, alpha read); cand == 0: K3b (they may be null)
extern "C" int srbd_sqp_onepass_launch(const float* consts, const float* xa, const float* us,
                                       const float* xr, const float* dxc, const float* duc,
                                       const float* alpha, const float* dx0, float* dx_out,
                                       float* du_out, float* dphi, float* theta, float* phi,
                                       float* maxdef, float* mincon, float* Acl, float* K,
                                       float* bcl, float* kv, float* q, float* rf, int N,
                                       int B, float mu_b, float theta_b, float reg, int cand,
                                       int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  if (cand)
    sqp_onepass_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi, theta, phi, maxdef,
        mincon, Acl, K, bcl, kv, q, rf, N, B, mu_b, theta_b, reg);
  else
    sqp_onepass_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi, theta, phi, maxdef,
        mincon, Acl, K, bcl, kv, q, rf, N, B, mu_b, theta_b, reg);
  return (int)cudaGetLastError();
}

#else  // host build: the same per-scenario body over every lane, in f64

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

extern "C" int srbd_sqp_onepass_host_f64(const host_t* consts, const host_t* xa,
                                         const host_t* us, const host_t* xr,
                                         const host_t* dxc, const host_t* duc,
                                         const host_t* alpha, const host_t* dx0,
                                         host_t* dx_out, host_t* du_out, host_t* dphi,
                                         host_t* theta, host_t* phi, host_t* maxdef,
                                         host_t* mincon, host_t* Acl, host_t* K, host_t* bcl,
                                         host_t* kv, host_t* q, host_t* rf, int N, int B,
                                         double mu_b, double theta_b, double reg, int cand) {
  for (int b = 0; b < B; ++b) {
    if (cand)
      k3::scenario<host_t, true>(consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out,
                                 dphi, theta, phi, maxdef, mincon, Acl, K, bcl, kv, q, rf,
                                 N, B, b, mu_b, theta_b, reg);
    else
      k3::scenario<host_t, false>(consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out,
                                  dphi, theta, phi, maxdef, mincon, Acl, K, bcl, kv, q, rf,
                                  N, B, b, mu_b, theta_b, reg);
  }
  return 0;
}

#endif
#endif  // K3_NO_ENTRIES
