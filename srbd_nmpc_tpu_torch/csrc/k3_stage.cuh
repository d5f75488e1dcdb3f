// K3's stage code, shared by the kernels of sqp_onepass.cu (K3s, the dense
// one-pass SQP trip's plane pass and rollout): the candidate's rows of a
// stage, the terminal stage, one stage's terms (srbd_soa's Jacobian blocks
// and four-call RK4, K5's evaluation order and not K1's shared chain; the
// leg-block-diagonal constraint rows and their relaxed barrier, Ru, q and
// r_eff), and a column of the closed-loop products Acl = A + B K and
// bcl = b + B kv.
//
// Contract: the plain PyTorch versions srbd_nmpc_tpu_torch/ops/
// sqp_kernel.py::sqp_qp_solve_onepass_cand_ref and ::sqp_qp_solve_onepass_ref.
// Full-precision math only, built with -fmad=false, sums in the plain
// version's order. Every function is __host__ __device__ and a template on
// the scalar type, so the kernels' bodies also compile as host C++ (without
// __CUDACC__).

#pragma once

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

}  // namespace k3
