// K1s's per-lane and per-team bodies, shared by the kernels of
// sqp_planes.cu (K1's three launches: the plane pass K1s-A, the team Riccati
// pass K1s-B and its rank-6 and factor forms, the rollout K1s-C) and by
// sqp_onepass.cu (K3s, whose Riccati pass is K1s-B and whose host build
// emulates it). sqp_planes.cu describes the design.
//
// Every body is written once for the card and the host: on the host a
// team's members run one after another within each step (team.cuh).

#pragma once

#include "k1_stage.cuh"
#include "team.cuh"

namespace k1s {

using namespace srbd_dev;
using namespace srbd_team;
using namespace k1;

// merit terms per stage [N, M_C, B] (as ops/sqp_planes.py::_M_*)
constexpr int M_UR = 0, M_EQ = 12, M_BAR = 24, M_CON = 25, M_C = 26;
// the terminal stage [T_C, B]: qN = Qf eN (12) and eN'qN
constexpr int T_PN = 12, T_C = 13;
// the card's team width and teams per block of the team kernel (8 W threads);
// its float64 form takes 4 teams a block (below)
constexpr int W_CARD = 16, TEAMS = 8, TEAMS_F64 = 4;

// ---------------------------------------------------------------------------
// K1s-A: one stage k < N of one lane (the linearization, the pack and the
// merit terms), or the terminal stage (k == N)
// ---------------------------------------------------------------------------
template <typename T>
HD void plane_stage(const T* kc, const T* xa, const T* us, const T* xr, const T* dxc,
                    const T* duc, const T* alpha, T* pack, T* mer, T* term, int N, int B,
                    int k, int b, T mu_b, T theta_b) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const T a = alpha[b];
  if (k == N) {
    const T* Qf = kc + K_QF;
    T eN[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      eN[i] = AT(xa, N * 12 + i) + a * AT(dxc, N * 12 + i) - AT(xr, N * 12 + i);
    T pn = T(0);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = Qf[12 * i] * eN[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
      AT(term, i) = acc;
      pn = (i == 0) ? eN[0] * acc : pn + eN[i] * acc;
    }
    AT(term, T_PN) = pn;
    return;
  }
  M3<T> Iinv;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Iinv.m[i][j] = kc[K_IINV + 3 * i + j];
  const T* Ac1 = kc + K_AC1;
  const T* Ac2 = kc + K_AC2;
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T log_th = k_log(theta_b);
  const T ddb_quad = mu_b / (theta_b * theta_b);

  T x[12], xn[12], u[12], e[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    x[i] = AT(xa, k * 12 + i) + a * AT(dxc, k * 12 + i);
    xn[i] = AT(xa, (k + 1) * 12 + i) + a * AT(dxc, (k + 1) * 12 + i);
    u[i] = AT(us, k * 12 + i) + a * AT(duc, k * 12 + i);
    e[i] = x[i] - AT(xr, k * 12 + i);
  }
  T D1[9], D2[9], sF[3], sr[3], sl[3], xnext[12];
  linearize_stage(kc, Iinv, x, u, D1, D2, sF, sr, sl, xnext);

  T* pk = pack + (size_t)k * P_C * B;
  T* mk = mer + (size_t)k * M_C * B;
#define PK(c) pk[(size_t)(c) * B + b]
#define MK(c) mk[(size_t)(c) * B + b]
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    PK(P_D1 + i) = D1[i];
    PK(P_D2 + i) = D2[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    PK(P_SF + i) = sF[i];
    PK(P_SR + i) = sr[i];
    PK(P_SL + i) = sl[i];
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) PK(P_B + i) = xnext[i] - xn[i];

  // constraints + relaxed barrier (24 rows): the stage's barrier sum and
  // least constraint, each in row order
  T db[24], s_bar = T(0), mincon = T(0);
#pragma unroll
  for (int g = 0; g < 24; ++g) {
    const T* arow = (g < 12) ? Ac1 + 6 * g : Ac2 + 6 * (g - 12);
    const T* ug = (g < 12) ? u : u + 6;
    T con = arow[0] * ug[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) con = con + arow[j] * ug[j];
    con = con + bc[g];
    mincon = (g == 0) ? con : (con < mincon || con != con ? con : mincon);
    const bool in_log = con > theta_b;
    const T vs = in_log ? con : theta_b;
    T bb, d, dd;
    if (in_log) {
      bb = -mu_b * k_log(vs);
      d = -mu_b / vs;
      dd = mu_b / (vs * vs);
    } else {
      const T z = (con - T(2) * theta_b) / theta_b;
      bb = T(0.5) * mu_b * (z * z - T(1)) - mu_b * log_th;
      d = mu_b * (con - T(2) * theta_b) / (theta_b * theta_b);
      dd = ddb_quad;
    }
    s_bar = (g == 0) ? bb : s_bar + bb;
    db[g] = d;
    PK(P_DDB + g) = dd;
  }
  MK(M_BAR) = s_bar;
  MK(M_CON) = mincon;

#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T qi = Qw[12 * i] * e[0];
    T ri = Rw[12 * i] * u[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) {
      qi = qi + Qw[12 * i + j] * e[j];
      ri = ri + Rw[12 * i + j] * u[j];
    }
    MK(M_EQ + i) = e[i] * qi;
    MK(M_UR + i) = u[i] * ri;
    const T* Ab = (i < 6) ? Ac1 + i : Ac2 + (i - 6);
    const T* dbl = (i < 6) ? db : db + 12;
    T acc = Ab[0] * dbl[0];
#pragma unroll
    for (int g = 1; g < 12; ++g) acc = acc + Ab[6 * g] * dbl[g];
    PK(P_Q + i) = qi;
    PK(P_RF + i) = ri + acc;
  }
#undef MK
#undef PK
#undef AT
}

// The float64 plane pass: a stage of a lane split between two threads
// (plane_part), each forming and storing its own channels with plane_stage's
// expressions and sum order (no sum split between them), so that neither
// holds the whole stage's live set. Pack, mer and term are plane_stage's bit
// for bit.
//
// plane_dyn, the dynamics part of stage k < N: D1, D2, sF, sr, sl (pack
// channels 0-26), each stored as soon as it is formed, before the RK4 step
// starts; then the defect x_next - x_{k+1} (channels 27-38), the RK4 sum
// kept as a running sum, the step reading x and u from the lane's staging
// area st (24 rows, stride ss) and I^-1 from the constants block anew at each
// use (k1::Staged). x's r and l are read first, the rest of x and u after
// the chain's stores.
template <typename T>
HD void plane_dyn(const T* kc, const T* xa, const T* us, const T* dxc, const T* duc,
                  const T* alpha, T* pack, int N, int B, int k, int b, T* st, int ss) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  if (k >= N) return;
  const T a = alpha[b];
  M3<T> Iinv;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Iinv.m[i][j] = kc[K_IINV + 3 * i + j];
  T* pk = pack + (size_t)k * P_C * B;
#define PK(c) pk[(size_t)(c) * B + b]
  T x[12], u[12];
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = AT(xa, k * 12 + i) + a * AT(dxc, k * 12 + i);
  T D1[9], D2[9], Jw[3];
  stage_chain(Iinv, x, D1, D2, Jw);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    PK(P_D1 + i) = D1[i];
    PK(P_D2 + i) = D2[i];
  }
#pragma unroll
  for (int i = 6; i < 12; ++i) x[i] = AT(xa, k * 12 + i) + a * AT(dxc, k * 12 + i);
#pragma unroll
  for (int i = 0; i < 12; ++i) u[i] = AT(us, k * 12 + i) + a * AT(duc, k * 12 + i);
  T sF[3], sr[3], sl[3];
  stage_skews(kc, x, u, sF, sr, sl);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    PK(P_SF + i) = sF[i];
    PK(P_SR + i) = sr[i];
    PK(P_SL + i) = sl[i];
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    st[i * ss] = x[i];
    st[(12 + i) * ss] = u[i];
  }
  T xnext[12];
  rk4_step<T, true>(kc, kc[K_DT], Staged<T>{kc + K_IINV, 1}, Staged<T>{st, ss},
                    Staged<T>{st + 12 * ss, ss}, Jw, sr, sl, xnext);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    PK(P_B + i) = xnext[i] - (AT(xa, (k + 1) * 12 + i) + a * AT(dxc, (k + 1) * 12 + i));
#undef PK
#undef AT
}

// plane_cost, the cost part of stage k: q and e_i (Q e)_i first (e then
// dies), then the barrier rows leg by leg in a loop (ddb, the barrier sum,
// the least constraint) with rf's barrier sums sum_g Ac[g][i] db[g] kept as
// running sums in g, so that no db is held, then u_i (R u)_i and rf; at
// k == N the terminal stage. It reads x, x_ref and u of the stage and the
// constants alone.
template <typename T>
HD void plane_cost(const T* kc, const T* xa, const T* us, const T* xr, const T* dxc,
                   const T* duc, const T* alpha, T* pack, T* mer, T* term, int N, int B,
                   int k, int b, T mu_b, T theta_b) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const T a = alpha[b];
  if (k == N) {
    const T* Qf = kc + K_QF;
    T eN[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      eN[i] = AT(xa, N * 12 + i) + a * AT(dxc, N * 12 + i) - AT(xr, N * 12 + i);
    T pn = T(0);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = Qf[12 * i] * eN[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
      AT(term, i) = acc;
      pn = (i == 0) ? eN[0] * acc : pn + eN[i] * acc;
    }
    AT(term, T_PN) = pn;
    return;
  }
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  T* pk = pack + (size_t)k * P_C * B;
  T* mk = mer + (size_t)k * M_C * B;
#define PK(c) pk[(size_t)(c) * B + b]
#define MK(c) mk[(size_t)(c) * B + b]
  T e[12];
#pragma unroll
  for (int i = 0; i < 12; ++i)
    e[i] = (AT(xa, k * 12 + i) + a * AT(dxc, k * 12 + i)) - AT(xr, k * 12 + i);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T qi = Qw[12 * i] * e[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) qi = qi + Qw[12 * i + j] * e[j];
    MK(M_EQ + i) = e[i] * qi;
    PK(P_Q + i) = qi;
  }
  T u[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) u[i] = AT(us, k * 12 + i) + a * AT(duc, k * 12 + i);
  const T log_th = k_log(theta_b);
  const T ddb_quad = mu_b / (theta_b * theta_b);
  const T* bc = kc + K_BC;
  T s_bar = T(0), mincon = T(0), rb[12];
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    const T* Ac = kc + (leg == 0 ? K_AC1 : K_AC2);
    const T* ul = u + 6 * leg;
#pragma unroll 1
    for (int r = 0; r < 12; ++r) {
      const int g = 12 * leg + r;
      const T* arow = Ac + 6 * r;
      T con = arow[0] * ul[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) con = con + arow[j] * ul[j];
      con = con + bc[g];
      mincon = (g == 0) ? con : (con < mincon || con != con ? con : mincon);
      const bool in_log = con > theta_b;
      const T vs = in_log ? con : theta_b;
      T bb, d, dd;
      if (in_log) {
        bb = -mu_b * k_log(vs);
        d = -mu_b / vs;
        dd = mu_b / (vs * vs);
      } else {
        const T z = (con - T(2) * theta_b) / theta_b;
        bb = T(0.5) * mu_b * (z * z - T(1)) - mu_b * log_th;
        d = mu_b * (con - T(2) * theta_b) / (theta_b * theta_b);
        dd = ddb_quad;
      }
      s_bar = (g == 0) ? bb : s_bar + bb;
      PK(P_DDB + g) = dd;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        rb[6 * leg + i] = (r == 0) ? arow[i] * d : rb[6 * leg + i] + arow[i] * d;
    }
  }
  MK(M_BAR) = s_bar;
  MK(M_CON) = mincon;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T ri = Rw[12 * i] * u[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) ri = ri + Rw[12 * i + j] * u[j];
    MK(M_UR + i) = u[i] * ri;
    PK(P_RF + i) = ri + rb[i];
  }
#undef MK
#undef PK
#undef AT
}

// the float64 plane pass's parts, a thread each per (stage, lane): 0 the
// dynamics (st, ss: the lane's staging area), 1 the costs and the terminal
// stage
constexpr int F64_PARTS = 2;

template <typename T>
HD void plane_part(int part, const T* kc, const T* xa, const T* us, const T* xr,
                   const T* dxc, const T* duc, const T* alpha, T* pack, T* mer, T* term, int N,
                   int B, int k, int b, T mu_b, T theta_b, T* st, int ss) {
  if (part == 0)
    plane_dyn(kc, xa, us, dxc, duc, alpha, pack, N, B, k, b, st, ss);
  else
    plane_cost(kc, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, k, b, mu_b, theta_b);
}

// ---------------------------------------------------------------------------
// K1s-B, a team of W threads per scenario
// ---------------------------------------------------------------------------

// the stage's 87 pack channels, in channel order
template <typename T> struct Stage {
  T D1[3][3], D2[3][3], sF[3], sr[3], sl[3], bv[12], q[12], rf[12], ddb[24];
};

// one scenario's per-team array: L's lower triangle row by row; U the rows
// of Ju'P at its columns 3..5, 9..11. 720 words, so that the two teams of a
// warp start 16 banks apart
template <typename T> struct Team {
  T P[12][12], V[12][12], Y[12][13], L[78], U[12][6];
  T Pbp[12], p[12], dinv[12];
  Stage<T> st;
  T pad[3];
};
static_assert(sizeof(Team<float>) == 720 * sizeof(float), "720 words a team");
// The float64 form keeps the layout, 720 doubles (5,760 B; the two teams of
// a warp are its two half-warps, which the card serves apart for 8-byte
// words, so the 16-bank offset is not needed). 4 teams and the constants
// block in double, 27,976 B, keep the block under the 48 KB of static
// shared memory and fit 8 blocks, 32 teams, in an SM's 228 KB; a block park
// of 4 lanes of 8 bytes is one 32-byte sector, as 8 floats are.
constexpr int F64_SHARED = TEAMS_F64 * (int)sizeof(Team<double>) + K_LEN * (int)sizeof(double);
static_assert(sizeof(Team<double>) == 720 * sizeof(double), "720 doubles a team");
static_assert(F64_SHARED <= 48 * 1024, "static shared memory of a float64 block");
static_assert(8 * (F64_SHARED + 1024) <= 228 * 1024, "8 float64 blocks an SM");


// component i of Jx' v (rows: D1' v0 | D2' v0 | SF' v1 | v2)
template <typename T>
HD T jxtv_at(const T (&D1)[3][3], const T (&D2)[3][3], const T* sF, const T* v, int i) {
  if (i < 3) return D1[0][i] * v[0] + D1[1][i] * v[1] + D1[2][i] * v[2];
  if (i < 6) return D2[0][i - 3] * v[0] + D2[1][i - 3] * v[1] + D2[2][i - 3] * v[2];
  if (i >= 9) return v[i - 3];
  T s[3];
  skewT_mul(sF, v[3], v[4], v[5], s);
  return s[i - 6];
}

// column j of V = Jx' P (rows: D1' P0 | D2' P0 | SF' P1 | P2) and
// Pb_p[j] = (P b + p)_j, the first step of the gains and the rank-6 team
// stages
template <typename T>
HD void v_column(const T (&P)[12][12], const Stage<T>& st, const T* p, int j,
                 T (&V)[12][12], T* Pbp) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[i][j] = st.D1[0][i] * P[0][j] + st.D1[1][i] * P[1][j] + st.D1[2][i] * P[2][j];
    V[3 + i][j] = st.D2[0][i] * P[0][j] + st.D2[1][i] * P[1][j] + st.D2[2][i] * P[2][j];
    V[9 + i][j] = P[6 + i][j];
  }
  T sv[3];
  skewT_mul(st.sF, P[3][j], P[4][j], P[5][j], sv);
  V[6][j] = sv[0];
  V[7][j] = sv[1];
  V[8][j] = sv[2];
  T acc = P[j][0] * st.bv[0];
#pragma unroll
  for (int c = 1; c < 12; ++c) acc = acc + P[j][c] * st.bv[c];
  Pbp[j] = acc + p[j];
}

// the words a form parks of a stage: the gains and rank-6 forms G_WORDS, K
// (e < 144, row by row) and kv (< 156); the factor form F_WORDS, Yh and yv
// in their place, L's lower triangle row by row (< 234) and dinv
constexpr int G_WORDS = 156, F_WORDS = 246;

// word e of the team's parked stage, from Y, L and dinv: the gains form's
// back substitution leaves [K | kv] in Y, the factor form parks [Yh | yv].
// L's diagonal is parked as the pivot times dinv: the team Cholesky leaves
// each pivot's last update to the members that read it
template <typename T>
HD T park_word(const Team<T>& s, int e) {
  if (e < 144) return s.Y[e / 12][e % 12];
  if (e < 156) return s.Y[e - 144][12];
  if (e < 234) {
    const int q = e - 156;
    int r, c;
    tri(q, r, c);
    T v = s.L[q];
    if (c == r) {
      if (r > 0) {
        const T l = s.L[li(r, r - 1)];
        v = v - l * l;
      }
      v = v * s.dinv[r];
    }
    return v;
  }
  return s.dinv[e - 234];
}

// the row of word e of stage k in the park arrays (K or Yh [N, 144, B], kv
// or yv [N, 12, B], L [N, 78, B], dinv [N, 12, B])
template <typename T>
HD T* park_row(T* park0, T* park1, T* park2, T* park3, int k, int e, int B) {
  if (e < 144) return park0 + ((size_t)k * 144 + e) * B;
  if (e < 156) return park1 + ((size_t)k * 12 + e - 144) * B;
  if (e < 234) return park2 + ((size_t)k * 78 + e - 156) * B;
  return park3 + ((size_t)k * 12 + e - 234) * B;
}

// kFactor: park0..park3 take [Yh | yv], L and dinv (ops/sqp_planes.py::
// park_shapes) in place of K and kv. On the card the
// block writes either park (park(k), once every team is done with stage k)
template <typename T, bool kFactor = false, typename Park = int>
HD void riccati_team(Team<T>& s, const T* kc, const T* pack, const T* term, T* park0,
                     T* park1, int N, int B, int b, T reg, int lane, int W, unsigned mask,
                     bool rev, T* park2 = nullptr, T* park3 = nullptr,
                     const Park& park = Park()) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  (void)lane;
  (void)mask;
  (void)rev;
  const T dt = kc[K_DT];
  const T dt2 = dt * dt;
  const T m_inv = T(1) / kc[K_MASS];
  const T* Ac1 = kc + K_AC1;
  const T* Ac2 = kc + K_AC2;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T* Qf = kc + K_QF;
  const Stage<T>& st = s.st;
  // X0 = Qw + P + dt (V + V') + dt^2 Jx'V', the part of P_new before
  // - Yh'Yh, by columns (at most two per member for W >= 8), kept across a
  // barrier
  T x0[SLOTS][2][12];

  // seed P = Qf, p = qN (read after the first stage's load is synced)
  TEAM_FOR(t) {
    for (int e = t; e < 144; e += W) s.P[e / 12][e % 12] = Qf[e];
    for (int i = t; i < 12; i += W) s.p[i] = AT(term, i);
  }
  for (int k = N - 1; k >= 0; --k) {
    const T* pk = pack + (size_t)k * P_C * B;
    T* flat = reinterpret_cast<T*>(&s.st);
    TEAM_FOR(t) {
      for (int c = t; c < P_C; c += W) flat[c] = pk[(size_t)c * B + b];
    }
    TEAM_SYNC();

    // column j of V = Jx' P (v_column), Pb_p[j] = (P b + p)_j,
    // and for j in 3..5, 9..11 column j of Ju'P (srbd_dev::ju_p)
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 12) {
        v_column(s.P, st, s.p, j, s.V, s.Pbp);
        if ((j >= 3 && j < 6) || j >= 9) {
          const int m = (j < 6) ? j - 3 : j - 6;
#pragma unroll
          for (int r = 0; r < 12; ++r) s.U[r][m] = ju_p(s.P, st.sr, st.sl, m_inv, r, j);
        }
      }
    }
    TEAM_SYNC();

    // column j of Y = [H | rv], of Ju'(P Ju) into G's lower triangle, and of
    // X0 (sqp_stage._riccati_stage_structured)
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 13) {
        if (j == 12) {
          T s1[3], s2[3];
          skewT_mul(st.sr, s.Pbp[3], s.Pbp[4], s.Pbp[5], s1);
          skewT_mul(st.sl, s.Pbp[3], s.Pbp[4], s.Pbp[5], s2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            s.Y[i][12] = dt * (s1[i] + m_inv * s.Pbp[9 + i]) + st.rf[i];
            s.Y[3 + i][12] = dt * s.Pbp[3 + i] + st.rf[3 + i];
            s.Y[6 + i][12] = dt * (s2[i] + m_inv * s.Pbp[9 + i]) + st.rf[6 + i];
            s.Y[9 + i][12] = dt * s.Pbp[3 + i] + st.rf[9 + i];
          }
        } else {
          T m1[3], m3[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            m1[i] = s.P[3 + i][j] + dt * s.V[j][3 + i];
            m3[i] = s.P[9 + i][j] + dt * s.V[j][9 + i];
          }
          T s1[3], s2[3];
          skewT_mul(st.sr, m1[0], m1[1], m1[2], s1);
          skewT_mul(st.sl, m1[0], m1[1], m1[2], s2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            s.Y[i][j] = dt * (s1[i] + m_inv * m3[i]);
            s.Y[3 + i][j] = dt * m1[i];
            s.Y[6 + i][j] = dt * (s2[i] + m_inv * m3[i]);
            s.Y[9 + i][j] = dt * m1[i];
          }
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            m1[i] = s.U[j][i];
            m3[i] = s.U[j][3 + i];
          }
          skewT_mul(st.sr, m1[0], m1[1], m1[2], s1);
          skewT_mul(st.sl, m1[0], m1[1], m1[2], s2);
          T col[12];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            col[i] = s1[i] + m_inv * m3[i];
            col[3 + i] = m1[i];
            col[6 + i] = s2[i] + m_inv * m3[i];
            col[9 + i] = m1[i];
          }
#pragma unroll
          for (int i = 0; i < 12; ++i) {
            if (i >= j) s.L[li(i, j)] = col[i];
            const T mv = dt * (s.V[j][i] + s.V[i][j]);
            MINE(x0)[q_][i] = ((Qw[12 * i + j] + s.P[i][j]) + mv)
                              + dt2 * jxt_m(s.V, st.D1, st.D2, st.sF, i, j);
          }
        }
      }
    }
    TEAM_SYNC();

    // G = Reff + dt^2 Ju'(P Ju) + reg I, entry by entry; X0 into V's place
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 78) {
        int i, j;
        tri(e, i, j);
        T re = Rw[12 * i + j];
        if ((i < 6) == (j < 6)) {
          const T* Ab = (i < 6) ? Ac1 : Ac2;
          const int ii = (i < 6) ? i : i - 6, jj = (j < 6) ? j : j - 6;
          const T* dd = st.ddb + ((i < 6) ? 0 : 12);
          T c = Ab[ii] * (Ab[jj] * dd[0]);
#pragma unroll
          for (int g = 1; g < 12; ++g) c = c + Ab[6 * g + ii] * (Ab[6 * g + jj] * dd[g]);
          re = re + c;
        }
        T gij = re + dt2 * s.L[e];
        if (i == j) gij = gij + reg;
        s.L[e] = gij;
      }
      TEAM_ITEMS(j, 12) {
#pragma unroll
        for (int i = 0; i < 12; ++i) s.V[i][j] = MINE(x0)[q_][i];
      }
    }
    TEAM_SYNC();

    // right-looking Cholesky, dinv = rsqrt(pivot), a row per member; forward
    // substitution Y <- L^-1 [H | rv], a column per member
    team_cholesky(s.L, s.dinv, lane, W, mask, rev);
    team_forward_subst(s.L, s.dinv, s.Y, lane, W, mask, rev);

    // P_new = 0.5 ((X0 - Yh'Yh) + (X0 - Yh'Yh)'), 78 entries in place, and
    // p_new = q + Pb_p + dt Jx' Pb_p - Yh' yv (12)
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 90) {
        if (e < 78) {
          int j, i;
          tri(e, j, i);  // i <= j
          T gr = s.Y[0][i] * s.Y[0][j];
#pragma unroll
          for (int r = 1; r < 12; ++r) gr = gr + s.Y[r][i] * s.Y[r][j];
          const T xij = s.V[i][j] - gr;
          const T xji = s.V[j][i] - gr;
          const T sym = T(0.5) * (xij + xji);
          s.P[i][j] = sym;
          s.P[j][i] = sym;
        } else {
          const int i = e - 78;
          T yy = s.Y[0][i] * s.Y[0][12];
#pragma unroll
          for (int r = 1; r < 12; ++r) yy = yy + s.Y[r][i] * s.Y[r][12];
          s.p[i] = ((st.q[i] + s.Pbp[i]) + dt * jxtv_at(st.D1, st.D2, st.sF, s.Pbp, i)) - yy;
        }
      }
    }
    TEAM_SYNC();

    if constexpr (!kFactor) {
      // back substitution L' X = Y in place, one column per member: column
      // c of Y becomes column c of [K | kv] = -X (a member reads only its
      // own column)
      TEAM_FOR(t) {
        TEAM_ITEMS(c, 13) {
          T y[12];
          back_subst_column(s.L, s.dinv, s.Y, c, y);
#pragma unroll
          for (int i = 0; i < 12; ++i) s.Y[i][c] = -y[i];
        }
      }
    }
    // park the stage (park_word): on the card from the whole block, on the
    // host a word a member
#ifdef __CUDA_ARCH__
    park(k);
#else
    (void)park;
    TEAM_FOR(t) {
      for (int e = t; e < (kFactor ? F_WORDS : G_WORDS); e += W)
        park_row(park0, park1, park2, park3, k, e, B)[b] = park_word(s, e);
    }
#endif
  }
#undef AT
}

// ---------------------------------------------------------------------------
// K1s-B, rank-6 form (ops/sqp_planes.py::_riccati_stage_rank6), a team of W
// threads per scenario
// ---------------------------------------------------------------------------

// one scenario's per-team array for the rank-6 stage. Y the rows sel(0..5)
// of P A; ra and rb hold what lives only part of a stage:
//   ra: L1, L2 [6][6] and d1, d2 (steps 1-3), then Pss Lt [6][6] (6-7), then
//       W K [6][12] and W kv (9-10);
//   rb: E1, E2, T, Lt, Lm [6][6] and dm (3-9), then K [12][12] and kv (10 to
//       the park).
// 784 words, so that the two teams of a warp start 16 banks apart
template <typename T> struct Team6 {
  T P[12][12], V[12][12], Y[6][12];
  T Pbp[12], p[12], rt[12], wr[6], zv[6];
  T ra[84], rb[186];
  Stage<T> st;
  T pad[19];
};
static_assert(sizeof(Team6<float>) == 784 * sizeof(float), "784 words a team");

// word e of the rank-6 team's parked stage: K and kv, which it leaves in rb
template <typename T>
HD T park_word(const Team6<T>& s, int e) { return s.rb[e]; }

// the 6x6 matrix at word off of a region
template <typename T>
HD T (&m6(T* region, int off))[6][6] { return *reinterpret_cast<T(*)[6][6]>(region + off); }
template <typename T>
HD T (&v6(T* region, int off))[6] { return *reinterpret_cast<T(*)[6]>(region + off); }

// row i of C' E for a W' block C = [[S', I/m], [I, 0]] (S = skew(s)), E's
// column given by e(k) = E[k][c], nonzero terms only, in the dense
// product's order
template <typename T, typename F>
HD T wt_row(const T* s, T m_inv, int i, F e) {
  if (i >= 3) return m_inv * e(i - 3);
  const int k0 = i == 0 ? 1 : 0, k1 = i == 2 ? 1 : 2;  // {0, 1, 2} \ {i}
  T acc = skew_at(s, i, k0) * e(k0);
  acc = acc + skew_at(s, i, k1) * e(k1);
  return acc + e(3 + i);
}

// entry (k, c) of the W' block C = [[S', I/m], [I, 0]]
template <typename T>
HD T wt_block(const T* s, T m_inv, int k, int c) {
  if (k < 3) return c < 3 ? skew_at(s, c, k) : (k == c - 3 ? m_inv : T(0));
  return (c < 3 && k - 3 == c) ? T(1) : T(0);
}

// a one-member Cholesky of the 6x6 lower triangle of S in place, through
// k1::cholesky on a copy in registers: S becomes the factor with zeros above
// the diagonal and the scaled pivots on it, as that body leaves it
template <typename T>
HD void cholesky6(T (&S)[6][6], T (&dinv)[6]) {
  T a[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = j <= i ? S[i][j] : T(0);
  T d[6];
  cholesky(a, d);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    dinv[i] = d[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) S[i][j] = a[i][j];
  }
}

// the L2 prefetch of the line holding p (nothing on the host)
HD void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// the team leaves K and kv in rb and, on the card, the block writes them
// (park(k), once every team is done with stage k)
template <typename T, typename Park = int>
HD void riccati_rank6_team(Team6<T>& s, const T* kc, const T* pack, const T* term, T* park0,
                           T* park1, int N, int B, int b, T reg, int lane, int W,
                           unsigned mask, bool rev, const Park& park = Park()) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  (void)lane;
  (void)mask;
  (void)rev;
  const T dt = kc[K_DT];
  const T dt2 = dt * dt;
  const T m_inv = T(1) / kc[K_MASS];
  const T* Ac1 = kc + K_AC1;
  const T* Ac2 = kc + K_AC2;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T* Qf = kc + K_QF;
  const Stage<T>& st = s.st;
  T(&L1)[6][6] = m6(s.ra, 0);
  T(&L2)[6][6] = m6(s.ra, 36);
  T(&d1)[6] = v6(s.ra, 72);
  T(&d2)[6] = v6(s.ra, 78);
  T(&PssLt)[6][6] = m6(s.ra, 0);
  T(&WK)[6][12] = *reinterpret_cast<T(*)[6][12]>(s.ra);
  T* const Wkv = s.ra + 72;
  T(&E1)[6][6] = m6(s.rb, 0);
  T(&E2)[6][6] = m6(s.rb, 36);
  T(&Tm)[6][6] = m6(s.rb, 72);
  T(&Lt)[6][6] = m6(s.rb, 108);
  T(&Lm)[6][6] = m6(s.rb, 144);
  T(&dm)[6] = v6(s.rb, 180);
  T(&Kp)[12][12] = *reinterpret_cast<T(*)[12][12]>(s.rb);
  T* const kvp = s.rb + 144;
  // Pss = the rows and columns sel(0..5) of P
  auto pss = [&](int i, int c) -> T { return s.P[sel(i)][sel(c)]; };
  // a member's columns of [K | kv], kept from step 9 to step 10
  T kcol[SLOTS][2][12];

  TEAM_FOR(t) {
    for (int e = t; e < 144; e += W) s.P[e / 12][e % 12] = Qf[e];
    for (int i = t; i < 12; i += W) s.p[i] = AT(term, i);
  }
  for (int k = N - 1; k >= 0; --k) {
    const T* pk = pack + (size_t)k * P_C * B;
    T* flat = reinterpret_cast<T*>(&s.st);
    TEAM_FOR(t) {
      for (int c = t; c < P_C; c += W) flat[c] = pk[(size_t)c * B + b];
    }
    TEAM_SYNC();

    // 1: columns of V = Jx' P with Pb_p; the lower entries of R1h and R2h,
    // R's leg blocks + Ac' diag(ddb) Ac + reg I. The next stage's pack is
    // asked into L2 meanwhile
    TEAM_FOR(t) {
      if (k > 0)
        for (int c = t; c < P_C; c += W) prefetch_l2(pk - (size_t)(P_C - c) * B + b);
      TEAM_ITEMS(e, 54) {
        if (e < 12) {
          v_column(s.P, st, s.p, e, s.V, s.Pbp);
        } else {
          const int leg = (e - 12) / 21;
          int i, j;
          tri(e - 12 - 21 * leg, i, j);
          const T* Ab = leg ? Ac2 : Ac1;
          const T* dd = st.ddb + 12 * leg;
          T c = Ab[i] * (Ab[j] * dd[0]);
#pragma unroll
          for (int g = 1; g < 12; ++g) c = c + Ab[6 * g + i] * (Ab[6 * g + j] * dd[g]);
          T v = Rw[12 * (6 * leg + i) + 6 * leg + j] + c;
          if (i == j) v = v + reg;
          (leg ? L2 : L1)[i][j] = v;
        }
      }
    }
    TEAM_SYNC();

    // 2: the two leg factors, a member each; Y = rows sel of P + dt V'
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 74) {
        if (e < 2) {
          cholesky6(e ? L2 : L1, e ? d2 : d1);
        } else {
          const int a = (e - 2) / 12, j = (e - 2) % 12;
          s.Y[a][j] = s.P[sel(a)][j] + dt * s.V[j][sel(a)];
        }
      }
    }
    TEAM_SYNC();

    // 3: E = R^-1 W' a column per member; r~ = R^-1 reff a leg per member
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 14) {
        const int leg = e < 12 ? e / 6 : e - 12, c = e % 6;
        T x[6][1];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          x[r][0] = e < 12 ? wt_block(leg ? st.sl : st.sr, m_inv, r, c) : st.rf[6 * leg + r];
        chol_solve(leg ? L2 : L1, leg ? d2 : d1, x);
        T* out = e < 12 ? &(leg ? E2 : E1)[0][c] : s.rt + 6 * leg;
        const int stride = e < 12 ? 6 : 1;
#pragma unroll
        for (int r = 0; r < 6; ++r) out[stride * r] = x[r][0];
      }
    }
    TEAM_SYNC();

    // 4: T = W R^-1 W' = C1' E1 + C2' E2 (and its copy into Lt) a column per
    // member; w_r = W r~ (the same for the column r~)
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 7) {
        const T* e1 = j < 6 ? &E1[0][j] : s.rt;
        const T* e2 = j < 6 ? &E2[0][j] : s.rt + 6;
        const int stride = j < 6 ? 6 : 1;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const T v = wt_row(st.sr, m_inv, i, [&](int r) { return e1[stride * r]; })
                      + wt_row(st.sl, m_inv, i, [&](int r) { return e2[stride * r]; });
          if (j < 6) {
            Tm[i][j] = v;
            Lt[i][j] = v;
          } else {
            s.wr[i] = v;
          }
        }
      }
    }
    TEAM_SYNC();

    // 5: T = Lt Lt' by one member; zvec = dt ys - dt^2 Pss w_r
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 7) {
        if (e == 0) {
          T dt6[6];
          cholesky6(Lt, dt6);
        } else {
          const int i = e - 1;
          T a = pss(i, 0) * s.wr[0];
#pragma unroll
          for (int c = 1; c < 6; ++c) a = a + pss(i, c) * s.wr[c];
          s.zv[i] = dt * s.Pbp[sel(i)] - dt2 * a;
        }
      }
    }
    TEAM_SYNC();

    // 6: Pss Lt by entries
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 36) {
        const int i = e / 6, j = e % 6;
        T a = pss(i, 0) * Lt[0][j];
#pragma unroll
        for (int c = 1; c < 6; ++c) a = a + pss(i, c) * Lt[c][j];
        PssLt[i][j] = a;
      }
    }
    TEAM_SYNC();

    // 7: the lower entries of Ms = I + dt^2 Lt' (Pss Lt)
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 21) {
        int i, j;
        tri(e, i, j);
        T a = Lt[0][i] * PssLt[0][j];
#pragma unroll
        for (int c = 1; c < 6; ++c) a = a + Lt[c][i] * PssLt[c][j];
        Lm[i][j] = i == j ? dt2 * a + T(1) : dt2 * a;
      }
    }
    TEAM_SYNC();

    // 8: Ms = Lm Lm' by one member
    TEAM_FOR(t) {
      if (t == 0) cholesky6(Lm, dm);
    }
    TEAM_SYNC();

    // 9: a column c per member of X = [Y | zvec] - dt^2 Pss Lt Ms^-1 Lt' [Y | zvec],
    // then its column of K = -dt [E1 Yh; E2 Yh] (kv = -[r~ + E zh] for
    // c = 12) and of W K = -dt T Yh (W kv = -(w_r + T zh))
    TEAM_FOR(t) {
      TEAM_ITEMS(c, 13) {
        T x[6], w[6][1], lw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = c < 12 ? s.Y[i][c] : s.zv[i];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          T a = Lt[0][i] * x[0];
#pragma unroll
          for (int r = 1; r < 6; ++r) a = a + Lt[r][i] * x[r];
          w[i][0] = a;
        }
        chol_solve(Lm, dm, w);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          T a = Lt[i][0] * w[0][0];
#pragma unroll
          for (int r = 1; r < 6; ++r) a = a + Lt[i][r] * w[r][0];
          lw[i] = a;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          T a = pss(i, 0) * lw[0];
#pragma unroll
          for (int r = 1; r < 6; ++r) a = a + pss(i, r) * lw[r];
          x[i] = x[i] - dt2 * a;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          T a = E1[i][0] * x[0], b2 = E2[i][0] * x[0], h = Tm[i][0] * x[0];
#pragma unroll
          for (int r = 1; r < 6; ++r) {
            a = a + E1[i][r] * x[r];
            b2 = b2 + E2[i][r] * x[r];
            h = h + Tm[i][r] * x[r];
          }
          if (c < 12) {
            MINE(kcol)[q_][i] = -dt * a;
            MINE(kcol)[q_][6 + i] = -dt * b2;
            WK[i][c] = -dt * h;
          } else {
            MINE(kcol)[q_][i] = -(s.rt[i] + a);
            MINE(kcol)[q_][6 + i] = -(s.rt[6 + i] + b2);
            Wkv[i] = -(s.wr[i] + h);
          }
        }
      }
    }
    TEAM_SYNC();

    // 10: P_new = Qw + P + dt (V' + V) + dt^2 Jx'V' + H'K symmetrized, 78
    // entry pairs in place, H'K = dt Y'(W K); p_new = q + Pb_p + dt Jx' Pb_p +
    // dt Y'(W kv); each member's columns of [K | kv] out of its registers
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 90) {
        if (e < 78) {
          int j, i;
          tri(e, j, i);  // i <= j
          T hij = s.Y[0][i] * WK[0][j], hji = s.Y[0][j] * WK[0][i];
#pragma unroll
          for (int r = 1; r < 6; ++r) {
            hij = hij + s.Y[r][i] * WK[r][j];
            hji = hji + s.Y[r][j] * WK[r][i];
          }
          const T mvv = dt * (s.V[j][i] + s.V[i][j]);
          const T xij = (((Qw[12 * i + j] + s.P[i][j]) + mvv)
                         + dt2 * jxt_m(s.V, st.D1, st.D2, st.sF, i, j)) + dt * hij;
          const T xji = (((Qw[12 * j + i] + s.P[j][i]) + mvv)
                         + dt2 * jxt_m(s.V, st.D1, st.D2, st.sF, j, i)) + dt * hji;
          const T sym = T(0.5) * (xij + xji);
          s.P[i][j] = sym;
          s.P[j][i] = sym;
        } else {
          const int i = e - 78;
          T acc = s.Y[0][i] * Wkv[0];
#pragma unroll
          for (int r = 1; r < 6; ++r) acc = acc + s.Y[r][i] * Wkv[r];
          s.p[i] = ((st.q[i] + s.Pbp[i]) + dt * jxtv_at(st.D1, st.D2, st.sF, s.Pbp, i))
                   + dt * acc;
        }
      }
      TEAM_ITEMS(c, 13) {
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          const T v = MINE(kcol)[q_][i];
          if (c < 12) Kp[i][c] = v;
          else kvp[i] = v;
        }
      }
    }
    TEAM_SYNC();

#ifdef __CUDA_ARCH__
    park(k);
#else
    (void)park;
    TEAM_FOR(t) {
      for (int e = t; e < G_WORDS; e += W)
        park_row(park0, park1, (T*)nullptr, (T*)nullptr, k, e, B)[b] = park_word(s, e);
    }
#endif
  }
#undef AT
}

// ---------------------------------------------------------------------------
// K1s-C: the rollout from K and kv (kFactor: from the factor in
// park0..park3), and the merit reduced over the stages in the plain
// version's order
// ---------------------------------------------------------------------------
template <typename T, bool kFactor = false>
HD void rollout(const T* kc, const T* pack, const T* mer, const T* term, const T* park0,
                const T* park1, const T* dx0, T* dx_out, T* du_out, T* dphi_out,
                T* theta_out, T* phi_out, T* maxdef_out, T* mincon_out, int N, int B,
                int b, const T* park2 = nullptr, const T* park3 = nullptr) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
#define PK(c) pk[(size_t)(c) * B + b]
#define MK(c) mk[(size_t)(c) * B + b]
  const T dt = kc[K_DT];
  const T m_inv = T(1) / kc[K_MASS];
  T dx[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) dx[i] = AT(dx0, i);
  T tot = 0;
  // per component over the stages: |b|^2, u (R u), e (Q e)
  T th[12], ur[12], eq[12];
  T s_bar = T(0), maxdef = T(0), mincon = T(0);
  for (int k = 0; k < N; ++k) {
    const T* pk = pack + (size_t)k * P_C * B;
    const T* mk = mer + (size_t)k * M_C * B;
    T du[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = AT(park0, (k * 12 + i) * 12) * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc = acc + AT(park0, (k * 12 + i) * 12 + j) * dx[j];
      du[i] = acc + AT(park1, k * 12 + i);
    }
    if constexpr (kFactor) {
      // du = -L'^-1 (Yh dx + yv)
#pragma unroll
      for (int i = 11; i >= 0; --i) {
        const T xi = du[i] * AT(park3, k * 12 + i);
        du[i] = xi;
#pragma unroll
        for (int r = 0; r < i; ++r) du[r] = du[r] - AT(park2, k * 78 + li(i, r)) * xi;
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) du[i] = -du[i];
    }
    T sF[3], sr[3], sl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sF[i] = PK(P_SF + i);
      sr[i] = PK(P_SR + i);
      sl[i] = PK(P_SL + i);
    }
    T jd[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T acc = PK(P_D1 + 3 * i) * dx[0];
      acc = acc + PK(P_D1 + 3 * i + 1) * dx[1];
      acc = acc + PK(P_D1 + 3 * i + 2) * dx[2];
      T acc2 = PK(P_D2 + 3 * i) * dx[3];
      acc2 = acc2 + PK(P_D2 + 3 * i + 1) * dx[4];
      acc2 = acc2 + PK(P_D2 + 3 * i + 2) * dx[5];
      jd[i] = acc + acc2;
    }
    T c1[3], c2[3], c3[3];
    cross3(sF, dx + 6, c1);
    cross3(sr, du, c2);
    cross3(sl, du + 6, c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      jd[3 + i] = (((c1[i] + c2[i]) + du[3 + i]) + c3[i]) + du[9 + i];
      jd[6 + i] = dx[9 + i];
      jd[9 + i] = m_inv * (du[i] + du[6 + i]);
    }
    T part_x = 0, part_u = 0;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      part_x += dx[i] * PK(P_Q + i);
      part_u += du[i] * PK(P_RF + i);
    }
    tot += part_x + part_u;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const T bi = PK(P_B + i);
      AT(du_out, k * 12 + i) = du[i];
      dx[i] = (dx[i] + bi) + dt * jd[i];
      AT(dx_out, k * 12 + i) = dx[i];

      const T ab = bi < 0 ? -bi : bi;
      maxdef = (k == 0 && i == 0) ? ab : (ab > maxdef || ab != ab ? ab : maxdef);
      th[i] = (k == 0) ? bi * bi : th[i] + bi * bi;
      ur[i] = (k == 0) ? MK(M_UR + i) : ur[i] + MK(M_UR + i);
      eq[i] = (k == 0) ? MK(M_EQ + i) : eq[i] + MK(M_EQ + i);
    }
    const T con = MK(M_CON);
    mincon = (k == 0) ? con : (con < mincon || con != con ? con : mincon);
    s_bar = (k == 0) ? MK(M_BAR) : s_bar + MK(M_BAR);
  }
  T last = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) last += dx[i] * AT(term, i);
  AT(dphi_out, 0) = tot + last;

  T theta = th[0], s_ur = ur[0], s_eq = eq[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) {
    theta = theta + th[i];
    s_ur = s_ur + ur[i];
    s_eq = s_eq + eq[i];
  }
  AT(theta_out, 0) = T(0.5) * theta;
  AT(phi_out, 0) = ((s_bar + T(0.5) * s_ur) + T(0.5) * s_eq) + T(0.5) * AT(term, T_PN);
  AT(maxdef_out, 0) = maxdef;
  AT(mincon_out, 0) = mincon;
#undef MK
#undef PK
#undef AT
}

}  // namespace k1s
