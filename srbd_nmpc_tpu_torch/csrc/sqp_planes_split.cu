// K1s · K1's gains body (the default fused SQP trip) as three launches:
//
//   K1s-A  k1s_planes_kernel         the plane pass, one thread per (stage, lane);
//   K1s-B  k1s_riccati_team_kernel   the backward Riccati pass, a team of
//                                    W = 16 threads of one warp per scenario;
//   K1s-C  k1s_rollout_kernel        the rollout, dphi and the merit's
//                                    reduction over the stages, one thread per
//                                    lane.
//
// Replaces the TPU kernel srbd_nmpc_tpu/ops/sqp_planes.py::
// _onepass_planes_kernel (:301, called at :582) with rank6=False,
// factor=False: its grid step 0 (_planes_phase, all N stages at once on
// [N, block] planes) and its backward steps (the structured stage
// sqp_pallas._riccati_stage_structured), then its forward epilogue.
// Contract: srbd_nmpc_tpu_torch/ops/sqp_planes.py::
// sqp_qp_solve_onepass_planes_ref with the default flags, as the one-thread
// body sqp_planes.cu <kGains>, which stays beside it.
//
// What bounds it on the H100: in one thread per scenario, the 12x12 stage's
// live set (P, V = Jx'P, [H | rv], the Cholesky factor: ~380 floats) sets
// the register budget of all three passes (the one-thread body: 255
// registers, 4.3 KB of spills per thread, two blocks of 128 per SM, 32
// blocks at the B/32 tier). Split, the plane pass and the rollout are bound
// by the bytes they move (the pack, the merit terms, the parked gains), and
// the Riccati pass, ~70 % of a call, by the instructions a team issues per
// stage and by shared memory, which holds 64 teams per SM; at the small
// tiers, by the latency of a stage's serial chain (12 pivots, 18 barriers).
//
// What this design does about it:
// - The plane pass holds no P. Its stages do not depend on one another, so
//   it runs N+1 threads per lane (row N: the terminal qN = Qf eN and eN'qN),
//   consecutive threads on consecutive lanes of one stage. It writes the
//   87-channel pack [N, 87, B] as the one-thread body does, and the merit's
//   per-stage terms [N, 26, B] (u_i (R u)_i, e_i (Q e)_i, the stage's
//   barrier sum and least constraint).
// - The Riccati pass keeps the stage's matrices in shared memory, one
//   per-team array per scenario (720 words), and spreads each step over the
//   team: columns of V = Jx'P with Pb_p and the rows of Ju'P that G needs;
//   columns of [H | rv], of G's Ju'PJu part and of X0 = Qw + P + dt (V + V')
//   + dt^2 Jx'V' (the part of P_new that needs no factor); the 78 entries of
//   G; the Cholesky factor a row per member, one barrier per column; the 13
//   columns of the forward and of the back substitution, each serial within
//   its column; the 78 entries of P and the 12 of p. Every entry is formed
//   by one thread with the one-thread body's expression, and every in-place
//   update of an entry keeps that body's order, so no sum is split between
//   threads: the team rounds exactly as the one-thread body does (the stage
//   is ill-conditioned enough, R_eff ~ 1e-4 against dt^2 B'PB, that another
//   sum order alone moves du by ~1e-4 relative). Members synchronize with
//   __syncwarp on the team's lanes between steps (18 per stage); the pack
//   and the parked gains are read and written by the team's members. The
//   team is 16 threads, two a warp: against one thread per scenario and
//   teams of 8 and 32, it was the fastest at each width the main path
//   launches on the H100 (PERF.md); the host build emulates widths 8 to 32.
// - The rollout holds dx, du and the merit's running sums, no P. It reduces
//   theta and phi over the stages in the plain version's order
//   (_planes_phase: per component over the stages, then over the
//   components), where the one-thread body sums stage by stage; dx, du,
//   dphi, max|defect| and min constraint are those of the one-thread body
//   bit for bit.
// No operation crosses scenarios, so a compacted launch gives bitwise the
// full-width result.
//
// Built with -fmad=false like every source (utils/build.py). The per-lane
// and per-team bodies compile as host C++ (without __CUDACC__): the host
// entry runs the three passes over every lane, each team's members one after
// another within each step through the same per-team array, in either
// member order, so that tests can hold it to the plain version (f64) and to
// the one-thread body's host build (f32, -DSRBD_HOST_F32) without a card.

#define K1_NO_ENTRIES
#include "sqp_planes.cu"
#include "team.cuh"

namespace k1s {

using namespace srbd_dev;
using namespace srbd_team;
using namespace k1;

// merit terms per stage [N, M_C, B] (as ops/sqp_planes.py::_M_*)
constexpr int M_UR = 0, M_EQ = 12, M_BAR = 24, M_CON = 25, M_C = 26;
// the terminal stage [T_C, B]: qN = Qf eN (12) and eN'qN
constexpr int T_PN = 12, T_C = 13;
// the card's team width and teams per block of the team kernel (8 W threads)
constexpr int W_CARD = 16, TEAMS = 8;

// ---------------------------------------------------------------------------
// K1s-A: one stage k < N of one lane (pass 1 of k1::scenario, with the merit
// terms written out), or the terminal stage (k == N)
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


// component i of Jx' v (srbd_dev::stage_jxt_v)
template <typename T>
HD T jxtv_at(const T (&D1)[3][3], const T (&D2)[3][3], const T* sF, const T* v, int i) {
  if (i < 3) return D1[0][i] * v[0] + D1[1][i] * v[1] + D1[2][i] * v[2];
  if (i < 6) return D2[0][i - 3] * v[0] + D2[1][i - 3] * v[1] + D2[2][i - 3] * v[2];
  if (i >= 9) return v[i - 3];
  T s[3];
  skewT_mul(sF, v[3], v[4], v[5], s);
  return s[i - 6];
}

template <typename T>
HD void riccati_team(Team<T>& s, const T* kc, const T* pack, const T* term, T* park0,
                     T* park1, int N, int B, int b, T reg, int lane, int W, unsigned mask,
                     bool rev) {
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

    // column j of V = Jx' P (srbd_dev::stage_jxt_p), Pb_p[j] = (P b + p)_j,
    // and for j in 3..5, 9..11 column j of Ju'P (srbd_dev::ju_p)
    TEAM_FOR(t) {
      TEAM_ITEMS(j, 12) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s.V[i][j] = st.D1[0][i] * s.P[0][j] + st.D1[1][i] * s.P[1][j]
                      + st.D1[2][i] * s.P[2][j];
          s.V[3 + i][j] = st.D2[0][i] * s.P[0][j] + st.D2[1][i] * s.P[1][j]
                          + st.D2[2][i] * s.P[2][j];
          s.V[9 + i][j] = s.P[6 + i][j];
        }
        T sv[3];
        skewT_mul(st.sF, s.P[3][j], s.P[4][j], s.P[5][j], sv);
        s.V[6][j] = sv[0];
        s.V[7][j] = sv[1];
        s.V[8][j] = sv[2];
        T acc = s.P[j][0] * st.bv[0];
#pragma unroll
        for (int c = 1; c < 12; ++c) acc = acc + s.P[j][c] * st.bv[c];
        s.Pbp[j] = acc + s.p[j];
        if ((j >= 3 && j < 6) || j >= 9) {
          const int m = (j < 6) ? j - 3 : j - 6;
#pragma unroll
          for (int r = 0; r < 12; ++r) s.U[r][m] = ju_p(s.P, st.sr, st.sl, m_inv, r, j);
        }
      }
    }
    TEAM_SYNC();

    // column j of Y = [H | rv], of Ju'(P Ju) into G's lower triangle, and of
    // X0 (riccati_stage_structured)
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

    // back substitution L' X = Y, one column per member; [K | kv] = -X.
    // No barrier after it: the next stage's load writes only the pack
    // channels, which this step does not read.
    TEAM_FOR(t) {
      TEAM_ITEMS(c, 13) {
        T y[12];
        back_subst_column(s.L, s.dinv, s.Y, c, y);
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          if (c < 12) AT(park0, (k * 12 + i) * 12 + c) = -y[i];
          else AT(park1, k * 12 + i) = -y[i];
        }
      }
    }
  }
#undef AT
}

// ---------------------------------------------------------------------------
// K1s-C: pass 3 of k1::scenario <kGains>, and the merit reduced over the
// stages in the plain version's order
// ---------------------------------------------------------------------------
template <typename T>
HD void rollout(const T* kc, const T* pack, const T* mer, const T* term, const T* park0,
                const T* park1, const T* dx0, T* dx_out, T* du_out, T* dphi_out,
                T* theta_out, T* phi_out, T* maxdef_out, T* mincon_out, int N, int B,
                int b) {
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

// K1S_NO_ENTRIES: the bodies alone, for a source that includes this one
// (sqp_onepass_split.cu, whose Riccati pass is k1s_riccati_team_kernel,
// launched through this source's srbd_k1s_riccati_launch)
#ifndef K1S_NO_ENTRIES
#ifdef __CUDACC__

// the constants block into shared memory, for the whole block
#define K1S_CONSTS                                                 \
  __shared__ float kc[k1::K_LEN];                                  \
  for (int i = threadIdx.x; i < k1::K_LEN; i += blockDim.x) kc[i] = consts[i]; \
  __syncthreads();

__global__ void __launch_bounds__(128, 3)
    k1s_planes_kernel(const float* __restrict__ consts, const float* xa, const float* us,
                      const float* xr, const float* dxc, const float* duc,
                      const float* alpha, float* pack, float* mer, float* term, int N,
                      int B, float mu_b, float theta_b) {
  K1S_CONSTS
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::plane_stage<float>(kc, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B,
                          blockIdx.y, b, mu_b, theta_b);
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 8)
    k1s_riccati_team_kernel(const float* __restrict__ consts, const float* pack,
                            const float* term, float* park0, float* park1, int N, int B,
                            float reg) {
  constexpr int W = k1s::W_CARD;
  static_assert(32 % W == 0, "a team lies within one warp");
  __shared__ k1s::Team<float> teams[k1s::TEAMS];
  K1S_CONSTS
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b = blockIdx.x * k1s::TEAMS + team;
  if (b >= B) return;  // the whole team leaves
  const unsigned mask = srbd_team::team_mask(W, (threadIdx.x & 31) / W);
  k1s::riccati_team<float>(teams[team], kc, pack, term, park0, park1, N, B, b, reg, lane, W,
                           mask, false);
}

__global__ void __launch_bounds__(128)
    k1s_rollout_kernel(const float* __restrict__ consts, const float* pack, const float* mer,
                       const float* term, const float* park0, const float* park1,
                       const float* dx0, float* dx_out, float* du_out, float* dphi,
                       float* theta, float* phi, float* maxdef, float* mincon, int N,
                       int B) {
  K1S_CONSTS
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::rollout<float>(kc, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
                      phi, maxdef, mincon, N, B, b);
}

constexpr int K1S_THREADS = 128;

// K1s-A: pack [N, 87, B], mer [N, 26, B], term [13, B]
extern "C" int srbd_k1s_planes_launch(const float* consts, const float* xa, const float* us,
                                      const float* xr, const float* dxc, const float* duc,
                                      const float* alpha, float* pack, float* mer,
                                      float* term, int N, int B, float mu_b, float theta_b,
                                      void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((B + K1S_THREADS - 1) / K1S_THREADS, N + 1);
  k1s_planes_kernel<<<grid, K1S_THREADS, 0, (cudaStream_t)stream>>>(
      consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, mu_b, theta_b);
  return (int)cudaGetLastError();
}

// K1s-B: parks K [N, 12, 12, B] and kv [N, 12, B]
extern "C" int srbd_k1s_riccati_launch(const float* consts, const float* pack,
                                       const float* term, float* park0, float* park1, int N,
                                       int B, float reg, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int teams = (B + k1s::TEAMS - 1) / k1s::TEAMS;
  k1s_riccati_team_kernel<<<teams, k1s::TEAMS * k1s::W_CARD, 0, (cudaStream_t)stream>>>(
      consts, pack, term, park0, park1, N, B, reg);
  return (int)cudaGetLastError();
}

// K1s-C: dx_out = dx[1:], out5 rows dphi, theta, phi, maxdef, mincon
extern "C" int srbd_k1s_rollout_launch(const float* consts, const float* pack,
                                       const float* mer, const float* term,
                                       const float* park0, const float* park1,
                                       const float* dx0, float* dx_out, float* du_out,
                                       float* dphi, float* theta, float* phi, float* maxdef,
                                       float* mincon, int N, int B, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k1s_rollout_kernel<<<(B + K1S_THREADS - 1) / K1S_THREADS, K1S_THREADS, 0,
                       (cudaStream_t)stream>>>(consts, pack, mer, term, park0, park1, dx0,
                                               dx_out, du_out, dphi, theta, phi, maxdef,
                                               mincon, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the three passes over every lane

using srbd_dev::host_t;

// the arguments of the three launches together; team: the team width the
// Riccati pass emulates (8 to 32; the card's is W_CARD), rev: the team's
// members in reverse order within each step
extern "C" int srbd_sqp_planes_split_host(int team, int rev, const host_t* consts,
                                          const host_t* xa, const host_t* us,
                                          const host_t* xr, const host_t* dxc,
                                          const host_t* duc, const host_t* alpha,
                                          const host_t* dx0, host_t* dx_out,
                                          host_t* du_out, host_t* dphi, host_t* theta,
                                          host_t* phi, host_t* maxdef, host_t* mincon,
                                          host_t* pack, host_t* mer, host_t* term,
                                          host_t* park0, host_t* park1, int N, int B,
                                          double mu_b, double theta_b, double reg) {
  if (team < 8 || team > 32) return 1;  // x0: two columns a member
  const host_t mu(mu_b), th(theta_b), rg(reg);
  for (int k = 0; k <= N; ++k)
    for (int b = 0; b < B; ++b)
      k1s::plane_stage(consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, k, b, mu,
                       th);
  for (int b = 0; b < B; ++b) {
    k1s::Team<host_t> s;
    k1s::riccati_team(s, consts, pack, term, park0, park1, N, B, b, rg, 0, team, 0u, rev != 0);
  }
  for (int b = 0; b < B; ++b)
    k1s::rollout(consts, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
                 phi, maxdef, mincon, N, B, b);
  return 0;
}

#endif
#endif  // K1S_NO_ENTRIES
