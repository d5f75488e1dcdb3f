// K1s · K1's three bodies (the gains body, the default fused SQP trip; the
// rank-6 body, rank6=True; the factor-parking body, park_factor=True) as
// three launches each:
//
//   K1s-A  k1s_planes_kernel         the plane pass, one thread per (stage,
//                                    lane); the same launch for every body;
//   K1s-B  k1s_riccati_team_kernel   the backward Riccati pass, a team of
//                                    W = 16 threads of one warp per scenario;
//          k1s_riccati_rank6_kernel  its rank-6 form: the 6x6 stage, K and kv
//                                    parked as the gains form parks them;
//          k1s_riccati_factor_kernel its factor form: the same stage, parking
//                                    the factor in place of the gains;
//   K1s-C  k1s_rollout_kernel        the rollout, dphi and the merit's
//                                    reduction over the stages, one thread per
//                                    lane (the gains and rank-6 bodies);
//          k1s_rollout_factor_kernel its factor form: du back-substituted
//                                    from the parked factor at every stage.
//
// Replaces the TPU kernel srbd_nmpc_tpu/ops/sqp_planes.py::
// _onepass_planes_kernel (:301, called at :582): its grid step 0
// (_planes_phase, all N stages at once on [N, block] planes) and its
// backward steps (the structured stage sqp_pallas._riccati_stage_structured;
// with rank6=True _riccati_stage_rank6, :77, chosen at :362-367; with
// factor=True the structured stage's return_factor form, :373-389), then
// its forward epilogue (with factor=True, t = Yh dx + yv, du =
// -bwd_subst(L, dinv, t), :408-416). Contract: srbd_nmpc_tpu_torch/ops/
// sqp_planes.py::sqp_qp_solve_onepass_planes_ref with the same rank6 /
// factor flags, as the one-thread bodies sqp_planes.cu <kGains>, <kRank6>
// and <kFactor>, which stay beside it.
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
//   its column and in place in Y; the 78 entries of P and the 12 of p.
//   Every entry is formed by one thread with the one-thread body's
//   expression, and every in-place update of an entry keeps that body's
//   order, so no sum is split between threads: the team rounds exactly as
//   the one-thread body does (the stage is ill-conditioned enough, R_eff ~
//   1e-4 against dt^2 B'PB, that another sum order alone moves du by ~1e-4
//   relative). Members synchronize with __syncwarp on the team's lanes
//   between steps (18 per stage). The team's members load its pack; the
//   whole block writes K and kv out of the teams' Y, between two block
//   barriers a stage, once every team is done with it (BlockPark): each
//   row's 8 lanes are one 32-byte sector, where the members of the two
//   teams of a warp would write 8-byte pieces of 16 rows (7.5 -> 6.7 ms a
//   call at B=131072 on the H100; the next stage's pack brought in by the
//   block in the same window, by cp.async, was slower at full width and not
//   kept, PERF.md). The team is 16 threads, two a warp: against one thread
//   per scenario and teams of 8 and 32, it was the fastest at each width
//   the main path launches on the H100 (PERF.md); the host build emulates
//   widths 8 to 32, its members parking their own words.
// - The rollout holds dx, du and the merit's running sums, no P. It reduces
//   theta and phi over the stages in the plain version's order
//   (_planes_phase: per component over the stages, then over the
//   components), where the one-thread body sums stage by stage; dx, du,
//   dphi, max|defect| and min constraint are those of the one-thread body
//   bit for bit.
// - The rank-6 form (k1s_riccati_rank6_kernel, a sibling of the gains team
//   body that shares its load and V/Pb_p step) spreads
//   k1::riccati_stage_rank6 over the team in 11 steps a stage: columns of
//   V with Pb_p beside the 42 lower entries of R1h/R2h; the two 6x6 leg
//   factors, a member each, beside the 72 entries of Y (rows sel of P A);
//   the 12 columns of E = R^-1 W' and the two legs of r~ (one code path);
//   the 6 columns of T (and its copy Lt) and the one of w_r; T's factor by
//   one member with zvec; Pss Lt; the 21 lower entries of Ms; Ms's factor
//   by one member; then one member per column of [Y | zvec] runs the whole
//   column chain (Lt', the Ms solve, Lt, Pss, the update) and forms its
//   column of K (kv) and of W K (W kv), K's in registers; last the 78
//   entry pairs of P, the 12 of p, and K and kv into the team's array. A
//   step's items take one code path where they can: a warp runs every
//   path that its members take. The 6x6 factors are k1::cholesky itself on
//   a copy in registers, a serial chain of six pivots in one member (a
//   team form, a barrier a column, was not measured). The next stage's
//   pack is asked into L2 at the start of each stage. The team array is
//   784 words (V, P, Y, the stage, and two regions that hold the 6x6
//   matrices of the stage's first half and W K, K and kv after them), 8
//   teams a block, 64 teams an SM; 64 registers. The block writes K and kv
//   as it writes the gains form's (the members' own store was slower on the
//   H100, PERF.md). Every entry keeps
//   k1::riccati_stage_rank6's expression and sum order, so the split
//   rounds as the one-thread body does.
// - The factor forms (a compile-time flag of the same team and rollout
//   bodies; the gains instantiations do not change) trade the team's
//   13-column back substitution for a serial one in the rollout: the team
//   parks [Yh | yv] (156 words a stage), L's lower triangle row by row (78,
//   its diagonal as the one-thread body leaves it) and dinv (12), 246 words
//   against the gains' 156. The whole block writes them as it writes the
//   gains (a team past the ragged edge repeats the last lane so that it
//   reaches the barriers). On the H100 the block's store took K1s-B's
//   factor form from 9.9 to 6.7 ms at B=131072 (PERF.md). The rollout forms
//   t = Yh dx + yv as the gains rollout forms K dx + kv, then x = L'^-1 t
//   in sqp_planes.cu's pass 3 order (i = 11 ... 0, t_r updated in
//   ascending r), du = -x: 90 more words read and 78 dependent
//   multiply-adds a stage, one thread a lane.
// - The float64 forms (k1s_planes_f64_kernel, k1s_riccati_team_f64_kernel,
//   k1s_rollout_f64_kernel; the gains body only) instantiate the same
//   Riccati and rollout bodies in double: the constants block, the team
//   array and the parks in double, the team array's layout kept, 4 teams a
//   block so that the block stays in static shared memory and its park rows
//   stay 32-byte sectors (F64_SHARED below). The plane pass in double is
//   not plane_stage's one thread a (stage, lane): that held the whole
//   stage's live set in 255 registers with 892 B of spill stores, two
//   blocks of 128 an SM, 4.3x its float32 form on the H100 where the other
//   two launches cost 2x. Its float64 form splits a (stage, lane) between
//   two threads (plane_part), each forming and storing its own channels
//   with plane_stage's expressions and sum order, so that the pass writes
//   plane_stage's pack, merit terms and terminal stage bit for bit: the
//   dynamics (the chain's blocks stored as formed, then the RK4 defect with
//   its sum kept as a running sum and x, u and I^-1 read anew at each use
//   from shared memory: held in registers, the step spilled at 128) and
//   the costs (the barrier rows leg by leg in a loop, rf's barrier sums kept
//   as running sums: unrolled with the 24 db held, the part spilled 1.8 KB
//   at 128 registers). One launch at 128 registers, four blocks (16 warps)
//   an SM, the two parts' blocks interleaved so that every wave mixes them:
//   6.2 -> 1.70 ms a call at B=131072 (PERF.md). ptxas spills 88 B there;
//   the parts as two launches without spills (the dynamics also reading
//   the feet, mass and dt anew) took 1.86 ms. The float32 plane pass keeps
//   plane_stage and its machine code.
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
// the card's team width and teams per block of the team kernel (8 W threads);
// its float64 form takes 4 teams a block (below)
constexpr int W_CARD = 16, TEAMS = 8, TEAMS_F64 = 4;

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

// column j of V = Jx' P (srbd_dev::stage_jxt_p) and Pb_p[j] = (P b + p)_j,
// the first step of the gains and the rank-6 team stages
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
// L's diagonal as the one-thread body leaves it, the pivot times dinv: the
// team Cholesky leaves each pivot's last update to the members that read it
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

// kFactor: park0..park3 take [Yh | yv], L and dinv (sqp_planes.cu's
// k1::scenario <kFactor> layout) in place of K and kv. On the card the
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

    // column j of V = Jx' P (srbd_dev::stage_jxt_p), Pb_p[j] = (P b + p)_j,
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
// K1s-B, rank-6 form (k1::riccati_stage_rank6), a team of W threads per
// scenario
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
// column given by e(k) = E[k][c]: k1::wt_mul's expression for that entry
template <typename T, typename F>
HD T wt_row(const T* s, T m_inv, int i, F e) {
  if (i >= 3) return m_inv * e(i - 3);
  const int k0 = i == 0 ? 1 : 0, k1 = i == 2 ? 1 : 2;  // {0, 1, 2} \ {i}
  T acc = skew_at(s, i, k0) * e(k0);
  acc = acc + skew_at(s, i, k1) * e(k1);
  return acc + e(3 + i);
}

// entry (k, c) of the W' block C = [[S', I/m], [I, 0]] (k1::riccati_stage_rank6)
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
    // (chol_solve_vec is chol_solve on one column)
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
// K1s-C: pass 3 of k1::scenario <kGains> (kFactor: <kFactor>, from the
// factor in park0..park3), and the merit reduced over the stages in the
// plain version's order
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

// K1S_NO_ENTRIES: the bodies alone, for a source that includes this one
// (sqp_onepass_split.cu, whose Riccati pass is k1s_riccati_team_kernel,
// launched through this source's srbd_k1s_riccati_launch)
#ifndef K1S_NO_ENTRIES
#ifdef __CUDACC__

// the constants block into shared memory, for the whole block, in the
// launch's scalar type T
#define K1S_CONSTS(T)                                              \
  __shared__ T kc[k1::K_LEN];                                      \
  for (int i = threadIdx.x; i < k1::K_LEN; i += blockDim.x) kc[i] = consts[i]; \
  __syncthreads();

__global__ void __launch_bounds__(128, 3)
    k1s_planes_kernel(const float* __restrict__ consts, const float* xa, const float* us,
                      const float* xr, const float* dxc, const float* duc,
                      const float* alpha, float* pack, float* mer, float* term, int N,
                      int B, float mu_b, float theta_b) {
  K1S_CONSTS(float)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::plane_stage<float>(kc, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B,
                          blockIdx.y, b, mu_b, theta_b);
}

// stage k's park from the whole block, between two block barriers, once
// every team is done with the stage: thread tid writes lane b0 + tid % NT
// of words tid / NT, + W, ..., so each row's NT lanes are one 32-byte
// sector (8 floats, or 4 doubles in the float64 form), where the members of
// the two teams of a warp would write pieces of 16 rows. WORDS words of
// each team's array (k1s::park_word): the gains and rank-6 forms' K and kv,
// the factor form's factor. A team past the ragged edge parks nothing.
template <typename TeamT, int WORDS, typename T = float, int NT = k1s::TEAMS>
struct BlockPark {
  const TeamT* teams;
  T *park0, *park1, *park2, *park3;
  int B, b0;
  __host__ __device__ void operator()(int k) const {
#ifdef __CUDA_ARCH__
    __syncthreads();  // every team is done with stage k
    const int sc = threadIdx.x % NT;
    if (b0 + sc < B)
      for (int e = threadIdx.x / NT; e < WORDS; e += k1s::W_CARD)
        k1s::park_row(park0, park1, park2, park3, k, e, B)[b0 + sc] =
            k1s::park_word(teams[sc], e);
    __syncthreads();  // before a team's next stage writes the parked words
#else
    (void)k;
#endif
  }
};

// a team past the ragged edge of the team kernels repeats the last lane
// and parks nothing, so that it reaches the block's barriers
__device__ __forceinline__ int team_lane(int b0, int team, int B) {
  return b0 + team < B ? b0 + team : B - 1;
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 8)
    k1s_riccati_team_kernel(const float* __restrict__ consts, const float* pack,
                            const float* term, float* park0, float* park1, int N, int B,
                            float reg) {
  constexpr int W = k1s::W_CARD;
  static_assert(32 % W == 0, "a team lies within one warp");
  __shared__ k1s::Team<float> teams[k1s::TEAMS];
  K1S_CONSTS(float)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS;
  const unsigned mask = srbd_team::team_mask(W, (threadIdx.x & 31) / W);
  const BlockPark<k1s::Team<float>, k1s::G_WORDS> park{teams, park0, park1, nullptr,
                                                        nullptr, B, b0};
  k1s::riccati_team<float>(teams[team], kc, pack, term, park0, park1, N, B,
                           team_lane(b0, team, B), reg, lane, W, mask, false, nullptr,
                           nullptr, park);
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 8)
    k1s_riccati_factor_kernel(const float* __restrict__ consts, const float* pack,
                              const float* term, float* park0, float* park1, float* park2,
                              float* park3, int N, int B, float reg) {
  constexpr int W = k1s::W_CARD;
  __shared__ k1s::Team<float> teams[k1s::TEAMS];
  K1S_CONSTS(float)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS;
  const unsigned mask = srbd_team::team_mask(W, (threadIdx.x & 31) / W);
  const BlockPark<k1s::Team<float>, k1s::F_WORDS> park{teams, park0, park1, park2,
                                                        park3, B, b0};
  k1s::riccati_team<float, true>(teams[team], kc, pack, term, park0, park1, N, B,
                                 team_lane(b0, team, B), reg, lane, W, mask, false, park2,
                                 park3, park);
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 8)
    k1s_riccati_rank6_kernel(const float* __restrict__ consts, const float* pack,
                             const float* term, float* park0, float* park1, int N, int B,
                             float reg) {
  constexpr int W = k1s::W_CARD;
  __shared__ k1s::Team6<float> teams[k1s::TEAMS];
  K1S_CONSTS(float)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS;
  const unsigned mask = srbd_team::team_mask(W, (threadIdx.x & 31) / W);
  const BlockPark<k1s::Team6<float>, k1s::G_WORDS> park{teams, park0, park1, nullptr,
                                                         nullptr, B, b0};
  k1s::riccati_rank6_team<float>(teams[team], kc, pack, term, park0, park1, N, B,
                                 team_lane(b0, team, B), reg, lane, W, mask, false, park);
}

__global__ void __launch_bounds__(128)
    k1s_rollout_kernel(const float* __restrict__ consts, const float* pack, const float* mer,
                       const float* term, const float* park0, const float* park1,
                       const float* dx0, float* dx_out, float* du_out, float* dphi,
                       float* theta, float* phi, float* maxdef, float* mincon, int N,
                       int B) {
  K1S_CONSTS(float)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::rollout<float>(kc, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
                      phi, maxdef, mincon, N, B, b);
}

__global__ void __launch_bounds__(128)
    k1s_rollout_factor_kernel(const float* __restrict__ consts, const float* pack,
                              const float* mer, const float* term, const float* park0,
                              const float* park1, const float* park2, const float* park3,
                              const float* dx0, float* dx_out, float* du_out, float* dphi,
                              float* theta, float* phi, float* maxdef, float* mincon, int N,
                              int B) {
  K1S_CONSTS(float)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::rollout<float, true>(kc, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi,
                            theta, phi, maxdef, mincon, N, B, b, park2, park3);
}

// The float64 forms of K1s-A, K1s-B (gains form) and K1s-C. K1s-A's: the
// two parts of a (stage, lane) (k1s::plane_part) on interleaved blocks,
// block x running part x % F64_PARTS of lanes 128 (x / F64_PARTS) ..., so
// that every wave mixes the chain-bound dynamics and the store-bound costs;
// 128 registers, four blocks (16 warps) an SM, the dynamics' x and u staged
// in shared memory (24 rows a thread, 24,576 B a block). K1s-B's and
// K1s-C's: the same bodies in double, the constants block and the team
// array in double, 4 teams a block (k1s::F64_SHARED); 8 blocks of 64
// threads an SM leave 128 registers a thread
__global__ void __launch_bounds__(128, 4)
    k1s_planes_f64_kernel(const double* __restrict__ consts, const double* xa,
                          const double* us, const double* xr, const double* dxc,
                          const double* duc, const double* alpha, double* pack, double* mer,
                          double* term, int N, int B, double mu_b, double theta_b) {
  K1S_CONSTS(double)
  __shared__ double st[24 * 128];
  const int part = blockIdx.x % k1s::F64_PARTS;
  const int b = (blockIdx.x / k1s::F64_PARTS) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::plane_part<double>(part, kc, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B,
                          blockIdx.y, b, mu_b, theta_b, st + threadIdx.x, 128);
}

__global__ void __launch_bounds__(k1s::TEAMS_F64 * k1s::W_CARD, 8)
    k1s_riccati_team_f64_kernel(const double* __restrict__ consts, const double* pack,
                                const double* term, double* park0, double* park1, int N,
                                int B, double reg) {
  constexpr int W = k1s::W_CARD;
  __shared__ k1s::Team<double> teams[k1s::TEAMS_F64];
  K1S_CONSTS(double)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS_F64;
  const unsigned mask = srbd_team::team_mask(W, (threadIdx.x & 31) / W);
  const BlockPark<k1s::Team<double>, k1s::G_WORDS, double, k1s::TEAMS_F64> park{
      teams, park0, park1, nullptr, nullptr, B, b0};
  k1s::riccati_team<double>(teams[team], kc, pack, term, park0, park1, N, B,
                            team_lane(b0, team, B), reg, lane, W, mask, false, nullptr,
                            nullptr, park);
}

__global__ void __launch_bounds__(128)
    k1s_rollout_f64_kernel(const double* __restrict__ consts, const double* pack,
                           const double* mer, const double* term, const double* park0,
                           const double* park1, const double* dx0, double* dx_out,
                           double* du_out, double* dphi, double* theta, double* phi,
                           double* maxdef, double* mincon, int N, int B) {
  K1S_CONSTS(double)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1s::rollout<double>(kc, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
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

// the rank-6 form of K1s-B (R leg-block-diagonal: the host decides): parks K
// [N, 12, 12, B] and kv [N, 12, B] as the gains form does
extern "C" int srbd_k1s_riccati_rank6_launch(const float* consts, const float* pack,
                                             const float* term, float* park0, float* park1,
                                             int N, int B, float reg, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int teams = (B + k1s::TEAMS - 1) / k1s::TEAMS;
  k1s_riccati_rank6_kernel<<<teams, k1s::TEAMS * k1s::W_CARD, 0, (cudaStream_t)stream>>>(
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

// the factor form of K1s-B: parks Yh [N, 12, 12, B], yv [N, 12, B], L's
// lower triangle [N, 78, B] and dinv [N, 12, B]
extern "C" int srbd_k1s_riccati_factor_launch(const float* consts, const float* pack,
                                              const float* term, float* park0, float* park1,
                                              float* park2, float* park3, int N, int B,
                                              float reg, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int teams = (B + k1s::TEAMS - 1) / k1s::TEAMS;
  k1s_riccati_factor_kernel<<<teams, k1s::TEAMS * k1s::W_CARD, 0, (cudaStream_t)stream>>>(
      consts, pack, term, park0, park1, park2, park3, N, B, reg);
  return (int)cudaGetLastError();
}

// the factor form of K1s-C, from K1s-B's factor parks
extern "C" int srbd_k1s_rollout_factor_launch(const float* consts, const float* pack,
                                              const float* mer, const float* term,
                                              const float* park0, const float* park1,
                                              const float* park2, const float* park3,
                                              const float* dx0, float* dx_out,
                                              float* du_out, float* dphi, float* theta,
                                              float* phi, float* maxdef, float* mincon, int N,
                                              int B, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k1s_rollout_factor_kernel<<<(B + K1S_THREADS - 1) / K1S_THREADS, K1S_THREADS, 0,
                              (cudaStream_t)stream>>>(consts, pack, mer, term, park0, park1,
                                                      park2, park3, dx0, dx_out, du_out,
                                                      dphi, theta, phi, maxdef, mincon, N, B);
  return (int)cudaGetLastError();
}

// the float64 forms of the three launches, as srbd_k1s_planes_launch,
// srbd_k1s_riccati_launch and srbd_k1s_rollout_launch in double
extern "C" int srbd_k1s_planes_f64_launch(const double* consts, const double* xa,
                                          const double* us, const double* xr,
                                          const double* dxc, const double* duc,
                                          const double* alpha, double* pack, double* mer,
                                          double* term, int N, int B, double mu_b,
                                          double theta_b, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid(k1s::F64_PARTS * ((B + K1S_THREADS - 1) / K1S_THREADS), N + 1);
  k1s_planes_f64_kernel<<<grid, K1S_THREADS, 0, (cudaStream_t)stream>>>(
      consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, mu_b, theta_b);
  return (int)cudaGetLastError();
}

extern "C" int srbd_k1s_riccati_f64_launch(const double* consts, const double* pack,
                                           const double* term, double* park0, double* park1,
                                           int N, int B, double reg, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + k1s::TEAMS_F64 - 1) / k1s::TEAMS_F64;
  k1s_riccati_team_f64_kernel<<<blocks, k1s::TEAMS_F64 * k1s::W_CARD, 0,
                                (cudaStream_t)stream>>>(consts, pack, term, park0, park1, N,
                                                        B, reg);
  return (int)cudaGetLastError();
}

extern "C" int srbd_k1s_rollout_f64_launch(const double* consts, const double* pack,
                                           const double* mer, const double* term,
                                           const double* park0, const double* park1,
                                           const double* dx0, double* dx_out, double* du_out,
                                           double* dphi, double* theta, double* phi,
                                           double* maxdef, double* mincon, int N, int B,
                                           void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k1s_rollout_f64_kernel<<<(B + K1S_THREADS - 1) / K1S_THREADS, K1S_THREADS, 0,
                           (cudaStream_t)stream>>>(consts, pack, mer, term, park0, park1,
                                                   dx0, dx_out, du_out, dphi, theta, phi,
                                                   maxdef, mincon, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the three passes over every lane

#include <type_traits>

using srbd_dev::host_t;

// K1s-A over every stage and lane: the one-thread plane_stage, or (split)
// the float64 form's parts, each over every stage and lane, in part order
// or (rev) in reverse
static void planes_host(bool split, bool rev, const host_t* consts, const host_t* xa,
                        const host_t* us, const host_t* xr, const host_t* dxc,
                        const host_t* duc, const host_t* alpha, host_t* pack, host_t* mer,
                        host_t* term, int N, int B, host_t mu, host_t th) {
  host_t st[24];
  for (int p = 0; p < (split ? k1s::F64_PARTS : 1); ++p)
    for (int k = 0; k <= N; ++k)
      for (int b = 0; b < B; ++b)
        if (split)
          k1s::plane_part(rev ? k1s::F64_PARTS - 1 - p : p, consts, xa, us, xr, dxc, duc, alpha,
                          pack, mer, term, N, B, k, b, mu, th, st, 1);
        else
          k1s::plane_stage(consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, k, b, mu,
                           th);
}

// the arguments of the three launches together, for the gains, rank-6 or
// factor body (k1::Body); the gains body's plane pass in double as the
// card's float64 form runs it (its parts in member order, rev)
template <int kBody>
static int split_host(int team, int rev, const host_t* consts, const host_t* xa,
                      const host_t* us, const host_t* xr, const host_t* dxc,
                      const host_t* duc, const host_t* alpha, const host_t* dx0,
                      host_t* dx_out, host_t* du_out, host_t* dphi, host_t* theta,
                      host_t* phi, host_t* maxdef, host_t* mincon, host_t* pack,
                      host_t* mer, host_t* term, host_t* park0, host_t* park1,
                      host_t* park2, host_t* park3, int N, int B, double mu_b,
                      double theta_b, double reg) {
  if (team < 8 || team > 32) return 1;  // x0, kcol: two columns a member
  constexpr bool kFactor = kBody == k1::kFactor;
  const host_t mu(mu_b), th(theta_b), rg(reg);
  planes_host(kBody == k1::kGains && std::is_same<host_t, double>::value, rev != 0, consts, xa,
              us, xr, dxc, duc, alpha, pack, mer, term, N, B, mu, th);
  for (int b = 0; b < B; ++b) {
    if constexpr (kBody == k1::kRank6) {
      k1s::Team6<host_t> s;
      k1s::riccati_rank6_team<host_t>(s, consts, pack, term, park0, park1, N, B, b, rg, 0,
                                      team, 0u, rev != 0);
    } else {
      k1s::Team<host_t> s;
      k1s::riccati_team<host_t, kFactor>(s, consts, pack, term, park0, park1, N, B, b, rg, 0,
                                         team, 0u, rev != 0, park2, park3);
    }
  }
  for (int b = 0; b < B; ++b)
    k1s::rollout<host_t, kFactor>(consts, pack, mer, term, park0, park1, dx0, dx_out, du_out,
                                  dphi, theta, phi, maxdef, mincon, N, B, b, park2, park3);
  return 0;
}

// K1s-A alone: pack [N, 87, B], mer [N, 26, B], term [13, B] by the
// one-thread plane_stage or (split) by the float64 form's parts, in either
// order (rev)
extern "C" int srbd_k1s_planes_host(int split, int rev, const host_t* consts, const host_t* xa,
                                    const host_t* us, const host_t* xr, const host_t* dxc,
                                    const host_t* duc, const host_t* alpha, host_t* pack,
                                    host_t* mer, host_t* term, int N, int B, double mu_b,
                                    double theta_b) {
  planes_host(split != 0, rev != 0, consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B,
              host_t(mu_b), host_t(theta_b));
  return 0;
}

// team: the team width the Riccati pass emulates (8 to 32; the card's is
// W_CARD), rev: the team's members in reverse order within each step
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
  return split_host<k1::kGains>(team, rev, consts, xa, us, xr, dxc, duc, alpha, dx0,
                                dx_out, du_out, dphi, theta, phi, maxdef, mincon, pack, mer,
                                term, park0, park1, nullptr, nullptr, N, B, mu_b, theta_b,
                                reg);
}

// the same for the rank-6 body (its K and kv in park0, park1)
extern "C" int srbd_sqp_planes_split_rank6_host(
    int team, int rev, const host_t* consts, const host_t* xa, const host_t* us,
    const host_t* xr, const host_t* dxc, const host_t* duc, const host_t* alpha,
    const host_t* dx0, host_t* dx_out, host_t* du_out, host_t* dphi, host_t* theta,
    host_t* phi, host_t* maxdef, host_t* mincon, host_t* pack, host_t* mer, host_t* term,
    host_t* park0, host_t* park1, int N, int B, double mu_b, double theta_b, double reg) {
  return split_host<k1::kRank6>(team, rev, consts, xa, us, xr, dxc, duc, alpha, dx0,
                                dx_out, du_out, dphi, theta, phi, maxdef, mincon, pack, mer,
                                term, park0, park1, nullptr, nullptr, N, B, mu_b, theta_b,
                                reg);
}

// the same for the factor body, with its four parks
extern "C" int srbd_sqp_planes_split_factor_host(
    int team, int rev, const host_t* consts, const host_t* xa, const host_t* us,
    const host_t* xr, const host_t* dxc, const host_t* duc, const host_t* alpha,
    const host_t* dx0, host_t* dx_out, host_t* du_out, host_t* dphi, host_t* theta,
    host_t* phi, host_t* maxdef, host_t* mincon, host_t* pack, host_t* mer, host_t* term,
    host_t* park0, host_t* park1, host_t* park2, host_t* park3, int N, int B, double mu_b,
    double theta_b, double reg) {
  return split_host<k1::kFactor>(team, rev, consts, xa, us, xr, dxc, duc, alpha, dx0,
                                 dx_out, du_out, dphi, theta, phi, maxdef, mincon, pack, mer,
                                 term, park0, park1, park2, park3, N, B, mu_b, theta_b, reg);
}

#endif
#endif  // K1S_NO_ENTRIES
