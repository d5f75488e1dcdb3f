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
// factor flags. The stage math is k1_stage.cuh's, the passes' bodies
// k1s_passes.cuh's.
//
// What bounds it on the H100: in one thread per scenario, the 12x12 stage's
// live set (P, V = Jx'P, [H | rv], the Cholesky factor: ~380 floats) sets
// the register budget of all three passes (255 registers, 4.3 KB of spills
// per thread, two blocks of 128 per SM, 32 blocks at the B/32 tier, as
// measured on the H100: PERF.md). Split, the plane pass and the rollout are bound
// by the bytes they move (the pack, the merit terms, the parked gains), and
// the Riccati pass, ~70 % of a call, by the SM's shared-memory pipe: a
// warp's shared load or store takes at least one of its cycles, and a load
// of 16 bytes by every member (4 a cycle) or a 4-byte load whose members'
// addresses share banks (a row of a 12-wide matrix: 4 a cycle) takes more
// (PERF.md). Then by the instructions a team issues and by the registers
// they hold; at the small tiers, by the latency of a stage's serial chain
// (12 pivots, 17 barriers).
//
// What this design does about it:
// - The plane pass holds no P. Its stages do not depend on one another, so
//   it runs N+1 threads per lane (row N: the terminal qN = Qf eN and eN'qN),
//   consecutive threads on consecutive lanes of one stage. It writes the
//   87-channel pack [N, 87, B] (ops/sqp_planes.py's channels), and the merit's
//   per-stage terms [N, 26, B] (u_i (R u)_i, e_i (Q e)_i, the stage's
//   barrier sum and least constraint).
// - The Riccati pass keeps the stage's matrices in shared memory, one
//   per-team array per scenario (752 words), and spreads each step over the
//   team: columns of V = Jx'P with Pb_p and the columns of Ju'P that G
//   needs; columns of [H | rv], of G's Ju'PJu part and of X0 = Qw + P + dt
//   (V + V') + dt^2 Jx'V' (the part of P_new that needs no factor, written
//   in P's place); G's 42 entries within a leg, then its 36 across the legs,
//   each in rounds of their own; the Cholesky factor and the forward
//   substitution in the same 12 steps, a row of L and a column of Y per
//   member in registers, each step reading L's row j + 1 once for both; the
//   78 entries of P, then the 12 of p; the 13 columns of the back
//   substitution from the members' registers. Every entry is formed by one
//   thread with one fixed expression, and every update of an entry keeps
//   one order, so no sum is split between threads: the team rounds alike at
//   every width and member order, and as one thread per scenario did (the
//   stage is ill-conditioned enough, R_eff ~ 1e-4 against dt^2 B'PB, that
//   another sum order alone moves du by ~1e-4 relative). Members
//   synchronize with __syncwarp on the team's lanes between steps (17 per
//   stage). To spare the shared-memory pipe, each operand that the whole
//   team reads is read 16 bytes at a time (the stage's groups, placed on
//   16-byte boundaries; Ac's and Q's columns, R's rows, copied so by the
//   block into its own constants (k1s::rc_word); L's rows, padded to 4
//   words; dinv), each operand a member uses again is read once into
//   registers (P's column and row, V's row, the columns of [H | rv], kept
//   as columns, Yc), and the factor's rows and Y's columns stay in
//   registers from the Cholesky to the back substitution: the static SASS
//   count of a stage fell from 757 shared loads and 204 stores to 243 and
//   107 (PERF.md). 8 teams a block, 6 blocks an SM at 80 registers (64
//   registers and 8 blocks spilled and were slower at each width). The
//   team's members load its pack; the whole block writes K and kv out of
//   the teams' Yc, between two block barriers a stage, once every team is
//   done with it (BlockPark): each row's 8 lanes are one 32-byte sector,
//   where the members of the two teams of a warp would write 8-byte pieces
//   of 16 rows (7.5 -> 6.7 ms a call at B=131072 on the H100; the next
//   stage's pack brought in by the block in the same window, by cp.async,
//   was slower at full width and not kept, PERF.md). The team is 16
//   threads, two a warp: against one thread per scenario and teams of 8
//   and 32, it was the fastest at each width the main path launches on the
//   H100 (PERF.md); the host build emulates widths 8 to 32, its members
//   parking their own words.
// - The rollout holds dx, du and the merit's running sums, no P. It reduces
//   theta and phi over the stages in the plain version's order
//   (_planes_phase: per component over the stages, then over the
//   components), not stage by stage.
// - The rank-6 form (k1s_riccati_rank6_kernel, a sibling of the gains team
//   body with its own per-team array and load, and the V/Pb_p step
//   v_column) spreads
//   the rank-6 stage (ops/sqp_planes.py::_riccati_stage_rank6) over the
//   team in 11 steps a stage: columns of
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
//   H100, PERF.md). Every entry keeps one expression and sum order, so the
//   team rounds alike at every width and member order.
// - The factor forms (a compile-time flag of the same team and rollout
//   bodies; the gains instantiations do not change) trade the team's
//   13-column back substitution for a serial one in the rollout: the team
//   parks [Yh | yv] (156 words a stage), L's lower triangle row by row (78,
//   its diagonal the pivot times dinv) and dinv (12), 246 words
//   against the gains' 156. The whole block writes them as it writes the
//   gains (a team past the ragged edge repeats the last lane so that it
//   reaches the barriers). On the H100 the block's store took K1s-B's
//   factor form from 9.9 to 6.7 ms at B=131072 (PERF.md). The rollout forms
//   t = Yh dx + yv as the gains rollout forms K dx + kv, then x = L'^-1 t
//   (i = 11 ... 0, t_r updated in
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
// member order, so that tests can hold it to the plain version (f64) and
// its f32 build (-DSRBD_HOST_F32) to stored digests of its outputs without a
// card.

#include "k1s_passes.cuh"

#include <type_traits>

#ifdef __CUDACC__

// the constants block into shared memory, for the whole block, in the
// launch's scalar type T
#define K1S_CONSTS(T)                                              \
  __shared__ T kc[k1::K_LEN];                                      \
  for (int i = threadIdx.x; i < k1::K_LEN; i += blockDim.x) kc[i] = consts[i]; \
  __syncthreads();

// K1s-B's constants (k1s::rc_word) into shared memory, for the whole block
#define K1S_RC(T)                                                  \
  __shared__ __align__(16) T rc[k1s::RC_LEN];                      \
  for (int i = threadIdx.x; i < k1s::RC_LEN; i += blockDim.x) rc[i] = k1s::rc_word(consts, i); \
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
    if (b0 + sc < B) {
      if constexpr (WORDS == k1s::G_WORDS && std::is_same_v<TeamT, k1s::Team<T>>) {
        // the gains form: K's words e = e0, e0 + 16, ... (all 144 in 9 rounds)
        // and kv's word e0, with park_word's and park_row's indices unrolled
        const int e0 = threadIdx.x / NT;
        const T* yc = &teams[sc].Yc[0][0];
        T* kp = park0 + (size_t)k * 144 * B + b0 + sc;
#pragma unroll
        for (int m = 0; m < 9; ++m) {
          const int e = e0 + k1s::W_CARD * m;
          kp[(size_t)e * B] = yc[12 * (e % 12) + e / 12];
        }
        if (e0 < 12) park1[((size_t)k * 12 + e0) * B + b0 + sc] = yc[144 + e0];
      } else {
        for (int e = threadIdx.x / NT; e < WORDS; e += k1s::W_CARD)
          k1s::park_row(park0, park1, park2, park3, k, e, B)[b0 + sc] =
              k1s::park_word(teams[sc], e);
      }
    }
    __syncthreads();  // before a team's next stage writes the parked words
#else
    (void)k;
#endif
  }
};

// a team past the ragged edge of the team kernels repeats the last lane
// and parks nothing, so that it reaches the block's barriers. The two teams
// of a warp thus run the same steps and reach each team barrier together:
// the gains and factor forms sync the whole warp (kWarp), a constant mask
// that spares the barrier its test of which lanes have arrived
constexpr unsigned kWarp = 0xffffffffu;
__device__ __forceinline__ int team_lane(int b0, int team, int B) {
  return b0 + team < B ? b0 + team : B - 1;
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 6)
    k1s_riccati_team_kernel(const float* __restrict__ consts, const float* pack,
                            const float* term, float* park0, float* park1, int N, int B,
                            float reg) {
  constexpr int W = k1s::W_CARD;
  static_assert(32 % W == 0, "a team lies within one warp");
  __shared__ k1s::Team<float> teams[k1s::TEAMS];
  K1S_RC(float)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS;
  const unsigned mask = kWarp;
  const BlockPark<k1s::Team<float>, k1s::G_WORDS> park{teams, park0, park1, nullptr,
                                                        nullptr, B, b0};
  k1s::riccati_team<float>(teams[team], consts, rc, pack, term, park0, park1, N, B,
                           team_lane(b0, team, B), reg, lane, W, mask, false, nullptr,
                           nullptr, park);
}

__global__ void __launch_bounds__(k1s::TEAMS * k1s::W_CARD, 6)
    k1s_riccati_factor_kernel(const float* __restrict__ consts, const float* pack,
                              const float* term, float* park0, float* park1, float* park2,
                              float* park3, int N, int B, float reg) {
  constexpr int W = k1s::W_CARD;
  __shared__ k1s::Team<float> teams[k1s::TEAMS];
  K1S_RC(float)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS;
  const unsigned mask = kWarp;
  const BlockPark<k1s::Team<float>, k1s::F_WORDS> park{teams, park0, park1, park2,
                                                        park3, B, b0};
  k1s::riccati_team<float, true>(teams[team], consts, rc, pack, term, park0, park1, N, B,
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
  K1S_RC(double)
  const int team = threadIdx.x / W, lane = threadIdx.x % W;
  const int b0 = blockIdx.x * k1s::TEAMS_F64;
  const unsigned mask = kWarp;
  const BlockPark<k1s::Team<double>, k1s::G_WORDS, double, k1s::TEAMS_F64> park{
      teams, park0, park1, nullptr, nullptr, B, b0};
  k1s::riccati_team<double>(teams[team], consts, rc, pack, term, park0, park1, N, B,
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

using srbd_dev::host_t;

// K1s-A over every stage and lane: plane_stage (the float32 form's body),
// or (split) the float64 form's parts, each over every stage and lane, in
// part order or (rev) in reverse
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
  host_t rc[k1s::RC_LEN];
  for (int i = 0; i < k1s::RC_LEN; ++i) rc[i] = k1s::rc_word(consts, i);
  for (int b = 0; b < B; ++b) {
    if constexpr (kBody == k1::kRank6) {
      k1s::Team6<host_t> s;
      k1s::riccati_rank6_team<host_t>(s, consts, pack, term, park0, park1, N, B, b, rg, 0,
                                      team, 0u, rev != 0);
    } else {
      k1s::Team<host_t> s;
      k1s::riccati_team<host_t, kFactor>(s, consts, rc, pack, term, park0, park1, N, B, b, rg,
                                         0, team, 0u, rev != 0, park2, park3);
    }
  }
  for (int b = 0; b < B; ++b)
    k1s::rollout<host_t, kFactor>(consts, pack, mer, term, park0, park1, dx0, dx_out, du_out,
                                  dphi, theta, phi, maxdef, mincon, N, B, b, park2, park3);
  return 0;
}

// K1s-A alone: pack [N, 87, B], mer [N, 26, B], term [13, B] by
// plane_stage or (split) by the float64 form's parts, in either order
// (rev)
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
