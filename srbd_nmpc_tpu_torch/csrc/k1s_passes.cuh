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

// the rank-6 form's stage: the 87 pack channels, in channel order
template <typename T> struct Stage {
  T D1[3][3], D2[3][3], sF[3], sr[3], sl[3], bv[12], q[12], rf[12], ddb[24];
};

// The gains and factor forms' stage, in shared memory: the 87 pack
// channels with each group that the whole team reads on a 16-byte boundary.
// jx: D1 (0-8), D2 (9-17), sF (18-20), sr (21-23), sl (24-26) and a pad word
template <typename T> struct alignas(16) StageA {
  T jx[28], bv[12], q[12], rf[12], ddb[24];
};
constexpr int SA_SF = 18, SA_SR = 21, SA_SL = 24;
// pack channel c's word in StageA
HD constexpr int stage_word(int c) { return c < P_B ? c : c + 1; }

// L's lower triangle by rows, row r at lo(r), each row padded to a multiple
// of 4 words (4 words for rows 0-3, 8 for 4-7, 12 for 8-11), so that a row
// is read 16 bytes at a time
HD constexpr int lo(int r) { return r < 4 ? 4 * r : r < 8 ? 8 * r - 16 : 12 * r - 48; }
HD constexpr int lp(int r, int c) { return lo(r) + c; }
constexpr int LP_LEN = 96;

// one scenario's per-team array for the gains and factor forms: Yc the
// columns of [H | rv] (Yc[c][i] = Y[i][c]), Uc the columns 3..5, 9..11 of
// Ju'P (Uc[m][r]), L by padded rows, the stage as StageA. Every field starts
// on a 16-byte boundary; 752 words, so that the two teams of a warp start 16
// banks apart
template <typename T> struct alignas(16) Team {
  T P[12][12], V[12][12], Yc[13][12], L[LP_LEN], Uc[6][12];
  T Pbp[12], p[12], dinv[12];
  StageA<T> st;
  T pad[16];
};
static_assert(sizeof(Team<float>) == 752 * sizeof(float), "752 words a team");

// K1s-B's constants (rc), in shared memory beside the teams: dt, the mass,
// Ac1's and Ac2's columns (RC_ACT + 72 leg + 12 k: column k of leg leg, its
// 12 rows g), R, and Q's columns (RC_Q + 12 j: column j); every matrix row
// and column on a 16-byte boundary
constexpr int RC_DT = 0, RC_MASS = 1, RC_ACT = 4, RC_R = 148, RC_Q = 292, RC_LEN = 436;

// word i of rc, from the constants block kc
template <typename T>
HD T rc_word(const T* kc, int i) {
  if (i == RC_DT) return kc[K_DT];
  if (i == RC_MASS) return kc[K_MASS];
  if (i < RC_ACT) return T(0);
  if (i < RC_R) {
    const int a = i - RC_ACT, leg = a / 72, k = (a % 72) / 12, g = a % 12;
    return kc[(leg == 0 ? K_AC1 : K_AC2) + 6 * g + k];
  }
  if (i < RC_Q) return kc[K_R + i - RC_R];
  const int a = i - RC_Q;
  return kc[K_Q + 12 * (a % 12) + a / 12];
}

// The float64 form keeps the layout, 752 doubles (6,016 B; the two teams of
// a warp are its two half-warps, which the card serves apart for 8-byte
// words, so the 16-bank offset is not needed). 4 teams and rc in double,
// 27,552 B, keep the block under the 48 KB of static shared memory and fit 8
// blocks, 32 teams, in an SM's 228 KB; a block park of 4 lanes of 8 bytes is
// one 32-byte sector, as 8 floats are.
constexpr int F64_SHARED = TEAMS_F64 * (int)sizeof(Team<double>) + RC_LEN * (int)sizeof(double);
static_assert(sizeof(Team<double>) == 752 * sizeof(double), "752 doubles a team");
static_assert(F64_SHARED <= 48 * 1024, "static shared memory of a float64 block");
static_assert(8 * (F64_SHARED + 1024) <= 228 * 1024, "8 float64 blocks an SM");

// the first n (<= cap, cap words by default) words at p, 16-byte aligned,
// into r: 16 bytes a load on the card (4 floats or 2 doubles; a load that
// starts below n reads its whole 16 bytes), word by word on the host. Where
// n is a loop's index, the card's loop is unrolled and the loads it needs
// are known when the kernel is compiled
template <int cap, typename T>
HD void ld16(const T* p, T* r, int n = cap) {
#ifdef __CUDA_ARCH__
  static_assert(cap % (16 / sizeof(T)) == 0, "whole 16-byte loads");
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < cap; i += 4)
      if (i < n) {
        const float4 a = *reinterpret_cast<const float4*>(p + i);
        r[i] = a.x;
        r[i + 1] = a.y;
        r[i + 2] = a.z;
        r[i + 3] = a.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < cap; i += 2)
      if (i < n) {
        const double2 a = *reinterpret_cast<const double2*>(p + i);
        r[i] = a.x;
        r[i + 1] = a.y;
      }
  }
#else
  for (int i = 0; i < n; ++i) r[i] = p[i];
#endif
}

// the first n (<= cap) words of r into p, 16-byte aligned: 16 bytes a
// store on the card (a store that starts below n writes its whole 16 bytes)
template <int cap, typename T>
HD void st16(T* p, const T* r, int n = cap) {
#ifdef __CUDA_ARCH__
  static_assert(cap % (16 / sizeof(T)) == 0, "whole 16-byte stores");
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < cap; i += 4)
      if (i < n)
        *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < cap; i += 2)
      if (i < n) *reinterpret_cast<double2*>(p + i) = make_double2(r[i], r[i + 1]);
  }
#else
  for (int i = 0; i < n; ++i) p[i] = r[i];
#endif
}

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
// Pb_p[j] = (P b + p)_j, the first step of the rank-6 team stage
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

// word e of the team's parked stage, from Yc, L and dinv: the gains form's
// back substitution leaves [K | kv] in Yc, the factor form parks [Yh | yv].
// L's diagonal is parked as the pivot times dinv: the team Cholesky leaves
// each pivot's last update to the members that read it
template <typename T>
HD T park_word(const Team<T>& s, int e) {
  if (e < 144) return s.Yc[e % 12][e / 12];
  if (e < 156) return s.Yc[12][e - 144];
  if (e < 234) {
    int r, c;
    tri(e - 156, r, c);
    T v = s.L[lp(r, c)];
    if (c == r) {
      if (r > 0) {
        const T l = s.L[lp(r, r - 1)];
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

// component i of Jx' v from the stage's jx words (jxtv_at's and jxt_m's
// expressions: Jx' V' takes v = V's row j)
template <typename T>
HD T jxt_at(const T* jx, const T* v, int i) {
  if (i < 3) return jx[i] * v[0] + jx[3 + i] * v[1] + jx[6 + i] * v[2];
  if (i < 6) return jx[6 + i] * v[0] + jx[9 + i] * v[1] + jx[12 + i] * v[2];
  if (i >= 9) return v[i - 3];
  T o[3];
  skewT_mul(jx + SA_SF, v[3], v[4], v[5], o);
  return o[i - 6];
}

// a member's (i, j) of its rounds' items (TEAM_ITEMS over n items), four
// to a word, formed once (pack_items): G's 42 entries within a leg (gw, leg
// by leg, row by row) and P's 78 lower entries (pw, row by row)
HD void g_within(int k, int& i, int& j) {
  const int leg = k < 21 ? 0 : 1;
  tri(k - 21 * leg, i, j);
  i += 6 * leg;
  j += 6 * leg;
}
template <typename F>
HD void pack_items(unsigned (&w)[4], int t, int W, int n, F ij) {
  for (int q = 0; q < 4; ++q) w[q] = 0u;
  for (int q = 0; q < 16 && t + q * W < n; ++q) {
    int i, j;
    ij(t + q * W, i, j);
    w[q / 4] |= (unsigned)(i | j << 4) << (8 * (q % 4));
  }
}
// round q's item of a member's packed words
HD void unpack_item(const unsigned (&w)[4], int q, int& i, int& j) {
  const unsigned v = w[q / 4] >> (8 * (q % 4));
  i = (int)(v & 15u);
  j = (int)((v >> 4) & 15u);
}

// kFactor: park0..park3 take [Yh | yv], L and dinv (ops/sqp_planes.py::
// park_shapes) in place of K and kv. kc: the constants block, whose Qf seeds
// P; rc: K1s-B's constants (rc_word). On the card the block writes either
// park (park(k), once every team is done with stage k).
//
// Each step reads what the whole team reads 16 bytes at a time (the stage's
// groups, Ac's columns, L's rows, dinv) and each operand a member uses again
// once, into registers (P's column and row, V's row, Yc's columns). The
// Cholesky and the forward substitution share their steps: step j reads L's
// row j + 1 once for both.
template <typename T, bool kFactor = false, typename Park = int>
HD void riccati_team(Team<T>& s, const T* kc, const T* rc, const T* pack, const T* term,
                     T* park0, T* park1, int N, int B, int b, T reg, int lane, int W,
                     unsigned mask, bool rev, T* park2 = nullptr, T* park3 = nullptr,
                     const Park& park = Park()) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  (void)lane;
  (void)mask;
  (void)rev;
  const T dt = rc[RC_DT];
  const T dt2 = dt * dt;
  const T m_inv = T(1) / rc[RC_MASS];
  const T* Qf = kc + K_QF;
  const StageA<T>& st = s.st;
  // across the Cholesky's steps: a member's rows r = t, t + W of L (G's
  // entries until formed) and their diagonals' updates, and its columns
  // c = t, t + W of Y
  T lr[SLOTS][2][12], dg[SLOTS][2], yc[SLOTS][2][12];
  // the pivots' dinv, which every member forms: kept in registers for the
  // back substitution in float; in shared memory (dinv) for the factor park
  // and in double
  constexpr bool kDinvShared = kFactor || sizeof(T) == 8;
  T dv[SLOTS][12];

  // the (i, j) of a member's G entries within a leg and P entries
  unsigned gw[SLOTS][4], pw[SLOTS][4];

  // seed P = Qf, p = qN (read after the first stage's load is synced)
  TEAM_FOR(t) {
    for (int e = t; e < 144; e += W) s.P[e / 12][e % 12] = Qf[e];
    for (int i = t; i < 12; i += W) s.p[i] = AT(term, i);
    pack_items(MINE(gw), t, W, 42, [](int e, int& i, int& j) { g_within(e, i, j); });
    pack_items(MINE(pw), t, W, 78, [](int e, int& i, int& j) { tri(e, j, i); });
  }
  for (int k = N - 1; k >= 0; --k) {
#ifdef __CUDA_ARCH__
    // the member's index and its items' words as this stage's own values, so
    // that the addresses they give are formed in each stage and not held in
    // registers through the loop
    int lane_k = lane;
    asm volatile("" : "+r"(lane_k));
    const int lane = lane_k;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      asm volatile("" : "+r"(MINE(gw)[q]));
      asm volatile("" : "+r"(MINE(pw)[q]));
    }
#endif
    const T* pk = pack + (size_t)k * P_C * B;
    T* sw = reinterpret_cast<T*>(&s.st);
    TEAM_FOR(t) {
      TEAM_ITEMS(c, P_C) sw[stage_word(c)] = pk[(size_t)c * B + b];
    }
    TEAM_SYNC();

    // column j of V = Jx' P, Pb_p[j] = (P b + p)_j (v_column's expressions),
    // and for j in 3..5, 9..11 column j of Ju'P (ju_p) into Uc: P's column
    // j read once, the stage's groups and P's row j 16 bytes at a time
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 12) {
        T pc[12], ja[12], jb[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) pc[i] = s.P[i][j];
        ld16<12>(st.jx, ja);       // D1, D2's row 0
        ld16<12>(st.jx + 12, jb);  // D2's rows 1-2, sF, sr
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s.V[i][j] = ja[i] * pc[0] + ja[3 + i] * pc[1] + ja[6 + i] * pc[2];
          s.V[3 + i][j] = ja[9 + i] * pc[0] + jb[i] * pc[1] + jb[3 + i] * pc[2];
          s.V[9 + i][j] = pc[6 + i];
        }
        T sv[3];
        skewT_mul(jb + 6, pc[3], pc[4], pc[5], sv);
        s.V[6][j] = sv[0];
        s.V[7][j] = sv[1];
        s.V[8][j] = sv[2];
        T acc = T(0);
#pragma unroll
        for (int c0 = 0; c0 < 12; c0 += 4) {
          T pr[4], bv[4];
          ld16<4>(s.P[j] + c0, pr);
          ld16<4>(st.bv + c0, bv);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc = (c0 + c == 0) ? pr[0] * bv[0] : acc + pr[c] * bv[c];
        }
        s.Pbp[j] = acc + s.p[j];
        if ((j >= 3 && j < 6) || j >= 9) {
          T sl[4], u[12];
          ld16<4>(st.jx + SA_SL, sl);
#pragma unroll
          for (int r = 0; r < 12; ++r) u[r] = ju_p(pc, jb + 9, sl, m_inv, r);
          st16<12>(s.Uc[j < 6 ? j - 3 : j - 6], u);
        }
      }
    }
    TEAM_SYNC();

    // column j of Y = [H | rv] (Yc), of Ju'(P Ju) into G's lower triangle, and
    // of X0 (sqp_stage._riccati_stage_structured) into P's column j, which no
    // member reads after this step; V's row j 16 bytes at a time
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 13) {
        T jb[12], sl[4], y[12], s1[3], s2[3];
        ld16<12>(st.jx + 12, jb);
        ld16<4>(st.jx + SA_SL, sl);
        const T* sr = jb + 9;
        if (j == 12) {
          T pb[12], rf[12];
          ld16<12>(s.Pbp, pb);
          ld16<12>(st.rf, rf);
          skewT_mul(sr, pb[3], pb[4], pb[5], s1);
          skewT_mul(sl, pb[3], pb[4], pb[5], s2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            y[i] = dt * (s1[i] + m_inv * pb[9 + i]) + rf[i];
            y[3 + i] = dt * pb[3 + i] + rf[3 + i];
            y[6 + i] = dt * (s2[i] + m_inv * pb[9 + i]) + rf[6 + i];
            y[9 + i] = dt * pb[3 + i] + rf[9 + i];
          }
          st16<12>(s.Yc[12], y);
        } else {
          T vr[12], m1[3], m3[3];
          ld16<12>(s.V[j], vr);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            m1[i] = s.P[3 + i][j] + dt * vr[3 + i];
            m3[i] = s.P[9 + i][j] + dt * vr[9 + i];
          }
          skewT_mul(sr, m1[0], m1[1], m1[2], s1);
          skewT_mul(sl, m1[0], m1[1], m1[2], s2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            y[i] = dt * (s1[i] + m_inv * m3[i]);
            y[3 + i] = dt * m1[i];
            y[6 + i] = dt * (s2[i] + m_inv * m3[i]);
            y[9 + i] = dt * m1[i];
          }
          st16<12>(s.Yc[j], y);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            m1[i] = s.Uc[i][j];
            m3[i] = s.Uc[3 + i][j];
          }
          skewT_mul(sr, m1[0], m1[1], m1[2], s1);
          skewT_mul(sl, m1[0], m1[1], m1[2], s2);
          T col[12];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            col[i] = s1[i] + m_inv * m3[i];
            col[3 + i] = m1[i];
            col[6 + i] = s2[i] + m_inv * m3[i];
            col[9 + i] = m1[i];
          }
#pragma unroll
          for (int i = 0; i < 12; ++i)
            if (i >= j) s.L[lp(i, j)] = col[i];
          // the stage's D1, D2 and sF in registers in float, read word by
          // word in double
          T jx[28];
          const T* jd = jx;
          if constexpr (sizeof(T) == 8) {
            jd = st.jx;
          } else {
            ld16<12>(st.jx, jx);
#pragma unroll
            for (int i = 12; i < 24; ++i) jx[i] = jb[i - 12];
          }
#pragma unroll
          for (int i0 = 0; i0 < 12; i0 += 4) {
            T qw[4];
            ld16<4>(rc + RC_Q + 12 * j + i0, qw);  // Qw[i][j]
#pragma unroll
            for (int i = i0; i < i0 + 4; ++i) {
              const T mv = dt * (vr[i] + s.V[i][j]);
              s.P[i][j] = ((qw[i - i0] + s.P[i][j]) + mv) + dt2 * jxt_at(jd, vr, i);
            }
          }
        }
      }
    }
    TEAM_SYNC();

    // G = Reff + dt^2 Ju'(P Ju) + reg I, entry by entry: the 42 entries
    // within a leg in rounds of their own (Ac's columns ii and jj and the
    // leg's ddb 16 bytes at a time), then the 36 across the legs (R alone)
    TEAM_FOR(t) {
      TEAM_ITEMS(k, 42) {
        int i, j;
        unpack_item(MINE(gw), q_, i, j);
        const int leg = (i < 6) ? 0 : 1;
        const T* ai = rc + RC_ACT + 72 * leg + 12 * (i - 6 * leg);
        const T* aj = rc + RC_ACT + 72 * leg + 12 * (j - 6 * leg);
        const T* dd = st.ddb + 12 * leg;
        T c = T(0);
#pragma unroll
        for (int g0 = 0; g0 < 12; g0 += 4) {
          T a4[4], b4[4], d4[4];
          ld16<4>(ai + g0, a4);
          ld16<4>(aj + g0, b4);
          ld16<4>(dd + g0, d4);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            c = (g0 + g == 0) ? a4[0] * (b4[0] * d4[0]) : c + a4[g] * (b4[g] * d4[g]);
        }
        const T re = rc[RC_R + 12 * i + j] + c;
        T gij = re + dt2 * s.L[lp(i, j)];
        if (i == j) gij = gij + reg;
        s.L[lp(i, j)] = gij;
      }
      TEAM_ITEMS(m, 36) {
        const int i = 6 + m / 6, j = m % 6;
        s.L[lp(i, j)] = rc[RC_R + 12 * i + j] + dt2 * s.L[lp(i, j)];
      }
    }
    TEAM_SYNC();

    // Cholesky of G, dinv = rsqrt(pivot), and forward substitution Y <- L^-1
    // [H | rv], in the same 12 steps. Step 0 scales column 0; step j + 1
    // reads L's row j + 1 with its diagonal's last update, forms the pivot
    // (every member, as team_cholesky's members do), L[r][j + 1] of the
    // member's rows r > j + 1 with the last of its diagonal's updates
    // (team_cholesky's operations on the entry, in its order), and y[j + 1]
    // of the member's columns (team_forward_subst's); the owner of row j + 2
    // writes it once complete. Every barrier but the last is the next step's
    // read of a row
    TEAM_FOR(t) {
      const T d0 = k_rsqrt(s.L[0]);
      MINE(dv)[0] = d0;
      if (kDinvShared && t == 0) s.dinv[0] = d0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = t + q * W;
        if (q * W < 12 && r < 12) {
          T* g = MINE(lr)[q];
          ld16<12>(s.L + lo(r), g);
          if (r >= 1) g[0] = g[0] * d0;
#pragma unroll
          for (int c = 0; c < 12; ++c)
            if (c == r) MINE(dg)[q] = g[c];
          if (r == 1) s.L[lp(1, 0)] = g[0];
        }
        if (q * W < 13 && r < 13) {
          T* y = MINE(yc)[q];
          ld16<12>(s.Yc[r], y);
          y[0] = y[0] * d0;
        }
      }
    }
    TEAM_SYNC();
#pragma unroll
    for (int j = 0; j < 11; ++j) {
      TEAM_FOR(t) {
        T l[12];
        ld16<12>(s.L + lo(j + 1), l, j + 2);
        const T lj = l[j];
        const T dn = k_rsqrt(l[j + 1] - lj * lj);
        MINE(dv)[j + 1] = dn;
        if (kDinvShared && t == 0) s.dinv[j + 1] = dn;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = t + q * W;
          if (q * W < 12 && r < 12 && r >= j + 2) {
            T* g = MINE(lr)[q];
            T a = g[j + 1];
#pragma unroll
            for (int i = 0; i < j; ++i) a = a - g[i] * l[i];
            g[j + 1] = (a - g[j] * lj) * dn;
            MINE(dg)[q] = MINE(dg)[q] - g[j] * g[j];
            if (r == j + 2) {
              T row[12];
#pragma unroll
              for (int c = 0; c < 12; ++c) row[c] = (c == j + 2) ? MINE(dg)[q] : g[c];
              st16<12>(s.L + lo(j + 2), row, j + 3);
            }
          }
          if (q * W < 13 && r < 13) {
            T* y = MINE(yc)[q];
            T a = y[j + 1];
#pragma unroll
            for (int i = 0; i <= j; ++i) a = a - l[i] * y[i];
            y[j + 1] = a * dn;
            if (j == 10) st16<12>(s.Yc[r], y);
          }
        }
      }
      TEAM_SYNC();
    }

    // P_new = 0.5 ((X0 - Yh'Yh) + (X0 - Yh'Yh)'), 78 entries in place (X0 in
    // P's place: entry (i, j) reads and writes X0[i][j] and X0[j][i] alone),
    // then in rounds of their own p_new = q + Pb_p + dt Jx' Pb_p - Yh' yv
    // (12); Yc's columns 16 bytes at a time
    TEAM_FOR(t) {
      TEAM_ITEMS(e, 78) {
        int i, j;
        unpack_item(MINE(pw), q_, i, j);  // i <= j
        T yi[12], yj[12];
        ld16<12>(s.Yc[i], yi);
        ld16<12>(s.Yc[j], yj);
        T gr = yi[0] * yj[0];
#pragma unroll
        for (int r = 1; r < 12; ++r) gr = gr + yi[r] * yj[r];
        const T xij = s.P[i][j] - gr;
        const T xji = s.P[j][i] - gr;
        const T sym = T(0.5) * (xij + xji);
        s.P[i][j] = sym;
        s.P[j][i] = sym;
      }
      TEAM_ITEMS(i, 12) {
        // column i is the member's own from the forward substitution (its
        // slot q_ holds column t + q_ W), in registers in float, read again
        // in double
        T yl[12], yv[12];
        const T* yi = MINE(yc)[q_];
        if constexpr (sizeof(T) == 8) {
          ld16<12>(s.Yc[i], yl);
          yi = yl;
        }
        ld16<12>(s.Yc[12], yv);
        T yy = yi[0] * yv[0];
#pragma unroll
        for (int r = 1; r < 12; ++r) yy = yy + yi[r] * yv[r];
        s.p[i] = ((st.q[i] + s.Pbp[i]) + dt * jxt_at(st.jx, s.Pbp, i)) - yy;
      }
    }
    TEAM_SYNC();

    if constexpr (!kFactor) {
      // back substitution L' X = Y in place, one column per member
      // (back_subst_column's operations): column c of Yc becomes column c of
      // [K | kv] = -X; L's rows and dinv 16 bytes at a time
      TEAM_FOR(t) {
        TEAM_ITEMS(c, 13) {
          // the member's column from the forward substitution, kept in
          // registers in float and read again in double
          T yl[12];
          T* y = yl;
          if constexpr (sizeof(T) == 8)
            ld16<12>(s.Yc[c], yl);
          else
            y = MINE(yc)[q_];
          T dl[12];
          const T* dn = MINE(dv);
          if constexpr (kDinvShared) {
            ld16<12>(s.dinv, dl);
            dn = dl;
          }
#pragma unroll
          for (int i = 11; i >= 0; --i) {
            y[i] = y[i] * dn[i];
            T l[12];
            ld16<12>(s.L + lo(i), l, i);
#pragma unroll
            for (int r = 0; r < i; ++r) y[r] = y[r] - l[r] * y[i];
          }
#pragma unroll
          for (int i = 0; i < 12; ++i) y[i] = -y[i];
          st16<12>(s.Yc[c], y);
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
