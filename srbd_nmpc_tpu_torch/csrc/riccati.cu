// K6 · batched LQR solve with S = 0: backward Riccati recursion, then forward
// rollout.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/riccati_pallas.py::
// _backward_kernel_constq (:100, stage-constant Q/Qf; K6a), _backward_kernel
// (:56, per-stage Q; K6b) and _forward_kernel (:142; K6c), all through
// lqr_solve_pallas (:161, pallas_call at :216 and :246); its K6a team pass
// with Acl and bcl is also K4a's Riccati pass (srbd_nmpc_tpu/ops/
// sqp_pallas.py::_bwd_kernel, :383). Contract: the plain
// PyTorch versions in srbd_nmpc_tpu_torch/ops/riccati_kernel.py.
//
// The rounding order is the TPU kernel's: G = R + B'PB + reg I with no
// symmetrization of G, a right-looking Cholesky with dinv = rsqrt(pivot), the
// 13-column forward and back substitution, K = -X[:, :12], k = -X[:, 12],
// P <- sym(Q + A'PA + H'K) and p <- q + A'Pb_p + H'k; every sum runs k = 0
// ... 11 left to right. The build uses -fmad=false, so the kernels round like
// the plain version, bit for bit in f32. No tensor cores: each product is
// 12x12 for one scenario, and TF32 would round away from the plain version.
//
// What bounds the backward pass on the H100: it is sequential over the
// stages, and each stage is a dense 12x12 Riccati update (~11.7 k
// multiply-adds, a Cholesky and a 13-column solve) on ~700 words of
// per-scenario state (P, PA, H, Y, the factor). In one thread per scenario
// that state does not fit in registers: 255 registers and 8-10 KB of spills
// per thread, and each stage input is fetched 12 to 36 times through L1/L2
// (PERF.md). The stage's inputs (A, B,
// R's lower triangle, b, q, r: 402 words per stage and scenario, and Q[g]'s
// 144 for a per-stage Q) are read once from device memory; their bytes and
// K, k's are the bound of the work.
//
// What the team design (riccati_team_kernel, K6a and K6b) does about it:
// - A team of 16 threads per scenario keeps P, (P A)', H', Y, L, dinv, Pb_p
//   and p in a per-team array in shared memory (k6t::Team, 720 words, so the
//   two teams of a warp start 16 banks apart), as K1s-B does (team.cuh),
//   with nothing spilled (128 registers for K6a, 4 blocks an SM; 148 for
//   K6b, 3). Each step spreads whole entries over the members: PA and P B by
//   half columns, with Pb_p; the columns of H = B'PA (into Y) and of
//   B'Pb_p + r, and G's lower triangle by entries; the Cholesky a row per
//   member with one barrier a column; the substitutions a column per
//   member; X = Q + A'PA + H'K by two rows of a column, then P = (X + X')/2
//   by entry pairs. Every entry is formed by one member with the
//   expression and sum order above, so no sum is split between members and
//   the team's rounding does not depend on its width.
//   Members synchronize with __syncwarp on the team's lanes (17 barriers a
//   stage). A and B are staged transposed, and PA, P B and H are kept
//   transposed, so that every 12-term sum reads its operands as 12-word
//   runs (three 16-byte loads each, load12).
// - The block's 8 teams hold consecutive lanes, so each row of a stage
//   input ((g * rows + row) * B + lane) is one 32-byte sector for the block.
//   The whole block copies stage g-1's rows of its lanes into shared memory
//   with cp.async while stage g is computed (two buffers), each scenario's
//   stage at a stride of 20 or 12 banks mod 32. K and k go out the same way:
//   once every team is done with a stage, the block writes each row's
//   sector from the teams' Y, before the next stage overwrites it.
// - Q and Qf (K6a) are one 288-word block in shared memory per block.
// - K4a's split (sqp_twopass.cu) runs K6a's body with a compile-time flag
//   (riccati_team_acl_kernel, a kernel of its own, so that K6a's and K6b's
//   code does not change): after P's symmetrization the members also form
//   Acl = A + B K, each a 3x3 tile of it (six words read a step for nine
//   products), and bcl = b + B k, from the staged B and the team's [K | k]
//   into (P A)' and Pb_p, which are spent by then; the block writes them
//   beside K and k.
// No operation crosses scenarios, so the ragged edge (lanes past B) only
// skips its copies, its writes and its teams' work. The team width (16) and
// the block (8 teams) won against 8x8, 32x8, 16x4 and 16x16 on the H100
// (PERF.md).
//
// The per-team body compiles as host C++ (without __CUDACC__): the host entry
// runs it over every lane with each team's members one after another within
// each step, in either order, at widths 8 to 32, in f64 and under
// -DSRBD_HOST_F32, so tests hold it to the plain version and its f32 build
// to stored digests of its outputs without a card.

#include "srbd_dev.cuh"
#include "team.cuh"

namespace k6 {

using namespace srbd_dev;

#define M(ptr, g, i, j) (ptr)[(((size_t)(g) * 12 + (i)) * 12 + (j)) * B + b]
#define V(ptr, g, i) (ptr)[((size_t)(g) * 12 + (i)) * B + b]

// rollout u = K x + k, x' = A x + B u + b from x_0 = x0
template <typename T>
HD void forward(const T* A, const T* Bm, const T* bv, const T* Kp, const T* kp,
                const T* x0, T* xo, T* uo, int N, int B, int b) {
  T x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = x0[(size_t)i * B + b];
  for (int g = 0; g < N; ++g) {
    T u[12], xn[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = M(Kp, g, i, 0) * x[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) acc = acc + M(Kp, g, i, k) * x[k];
      u[i] = acc + V(kp, g, i);
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T ax = M(A, g, i, 0) * x[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) ax = ax + M(A, g, i, k) * x[k];
      T bu = M(Bm, g, i, 0) * u[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) bu = bu + M(Bm, g, i, k) * u[k];
      xn[i] = (ax + bu) + V(bv, g, i);
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      V(uo, g, i) = u[i];
      V(xo, g, i) = xn[i];
      x[i] = xn[i];
    }
  }
#undef V
#undef M
}

}  // namespace k6

// ---------------------------------------------------------------------------
// K6's backward pass, a team of W threads per scenario
// ---------------------------------------------------------------------------
namespace k6t {

using namespace srbd_dev;
using namespace srbd_team;

// the card's team width and teams per block
constexpr int W_CARD = 16, TEAMS = 8;

// a stage's inputs for one scenario as the block stages them, word offsets:
// A and B transposed (At[j][k] = A[k][j], so that every product reads a
// 12-word run), R's lower triangle row by row (li), b, q[g], r and, for a
// per-stage Q, Q[g] row-major
constexpr int IN_A = 0, IN_B = 144, IN_R = 288, IN_BV = 366, IN_Q = 378, IN_RV = 390,
              IN_QG = 402;
// shared words of one scenario's staged inputs: 404 and 556 are 20 and 12 mod
// 32, so that the 8 scenarios of a copy's warp-wide store start 8 distinct
// multiples of 4 banks apart and two teams' 12-wide column reads do not meet;
// both keep every 12-word run 16-byte aligned
HD constexpr int in_stride(bool const_q) { return const_q ? 404 : 556; }

// one scenario's per-team array. PAt = (P A)'; Ht holds (P B)' until G is
// formed, then H'; Y the right-hand sides [H | B'Pb_p + r], then X, then
// [K | k]; P holds X = Q + A'PA + H'K transposed before its symmetrization;
// L the factor's lower triangle row by row. 720 words, so that the two teams
// of a warp start 16 banks apart; 16-byte aligned, as every 12-word run read
// with load12 is
template <typename T> struct alignas(16) Team {
  T P[12][12], PAt[12][12], Ht[12][12], Y[12][13];
  T Pbp[12], p[12], dinv[12], L[78];
  T pad[18];
};
static_assert(sizeof(Team<float>) == 720 * sizeof(float), "720 words a team");

// v[0..11] = p[0..11], p 16-byte aligned: three 16-byte loads on the card
template <typename T>
HD void load12(const T* p, T (&v)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = p[k];
}
#ifdef __CUDA_ARCH__
template <>
HD void load12<float>(const float* p, float (&v)[12]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float4 w = p4[m];
    v[4 * m] = w.x;
    v[4 * m + 1] = w.y;
    v[4 * m + 2] = w.z;
    v[4 * m + 3] = w.w;
  }
}
#endif

// sum_k u[k] v[k], k = 0 ... 11 left to right
template <typename T>
HD T dot12(const T (&u)[12], const T (&v)[12]) {
  T acc = u[0] * v[0];
#pragma unroll
  for (int k = 1; k < 12; ++k) acc = acc + u[k] * v[k];
  return acc;
}

// R's row (12 i + j) of each of its staged lower entries e = li(i, j)
HD void r_rows(int* rrow, int first, int step) {
  for (int e = first; e < 78; e += step) {
    int i, j;
    tri(e, i, j);
    rrow[e] = 12 * i + j;
  }
}

// stage g's inputs of lane ln into its staged array d, copy(dst, src) word
// by word: rows first, first + step, ... of each input (Qg: Q [N+1,12,12,B]
// when !CONST_Q)
#ifdef __CUDACC__
#pragma nv_exec_check_disable  // copy is a device-only cp.async on the card
#endif
template <bool CONST_Q, typename T, typename Copy>
HD void stage_inputs(T* d, const T* A, const T* Bm, const T* bv, const T* Qg, const T* R,
                     const T* q, const T* r, const int* rrow, int g, int B, size_t ln,
                     int first, int step, Copy copy) {
  const size_t m = (size_t)g * 144, v = (size_t)g * 12;
  for (int row = first; row < 144; row += step) {  // row k * 12 + j to j * 12 + k
    const int t = 12 * (row % 12) + row / 12;
    copy(d + IN_A + t, A + (m + row) * B + ln);
    copy(d + IN_B + t, Bm + (m + row) * B + ln);
  }
  for (int e = first; e < 78; e += step) copy(d + IN_R + e, R + (m + rrow[e]) * B + ln);
  for (int i = first; i < 12; i += step) {
    copy(d + IN_BV + i, bv + (v + i) * B + ln);
    copy(d + IN_Q + i, q + (v + i) * B + ln);
    copy(d + IN_RV + i, r + (v + i) * B + ln);
  }
  if (!CONST_Q)
    for (int row = first; row < 144; row += step) copy(d + IN_QG + row, Qg + (m + row) * B + ln);
}

// P = Qf (Qc = [Q | Qf]) or Q[N] (Qg [N+1,12,12,B]), p = q[N]
template <typename T, bool CONST_Q>
HD void seed(Team<T>& s, const T* Qc, const T* Qg, const T* q, int N, int B, int b, int lane,
             int W, bool rev) {
  (void)lane;
  (void)rev;
  TEAM_FOR(t) {
    for (int e = t; e < 144; e += W)
      s.P[e / 12][e % 12] = CONST_Q ? Qc[144 + e] : Qg[((size_t)N * 144 + e) * B + b];
    for (int i = t; i < 12; i += W) s.p[i] = q[((size_t)N * 12 + i) * B + b];
  }
}

// one stage of the backward recursion: in the stage's staged inputs, Qc the
// shared [Q | Qf] (CONST_Q). Leaves the stage's [K | k] in Y, and with ACL
// its closed-loop Acl = A + B K in PAt (row-major) and bcl = b + B k in Pbp.
// Starts after a barrier that makes P, p and the inputs visible to every
// member; ends with no barrier (the block's ends the stage).
template <typename T, bool CONST_Q, bool ACL = false>
HD void stage(Team<T>& s, const T* in, const T* Qc, T reg, int lane, int W, unsigned mask,
              bool rev) {
  (void)lane;
  (void)mask;
  (void)rev;
  const T* At = in + IN_A;  // At[j][k] = A[k][j] at 12 j + k
  const T* Bt = in + IN_B;
  const T* Q = CONST_Q ? Qc : in + IN_QG;

  // PA = P A and P B by half columns (rows 6h ... 6h + 5 of column j) into
  // PAt and Ht; Pb_p[j] = (P b)_j + p_j beside the first half of P B's
  TEAM_FOR(t) {
    TEAM_ITEMS(e, 48) {
      const int c = e >> 1, h = e & 1;
      const bool pa = c < 12;
      const int j = pa ? c : c - 12;
      T col[12], row[12];
      load12((pa ? At : Bt) + 12 * j, col);
      T* dst = pa ? s.PAt[j] : s.Ht[j];
#pragma unroll
      for (int i = 6 * h; i < 6 * h + 6; ++i) {
        load12(s.P[i], row);
        dst[i] = dot12(row, col);
      }
      if (!pa && h == 0) {
        const T* bv = in + IN_BV;
        T acc = s.P[j][0] * bv[0];
#pragma unroll
        for (int k = 1; k < 12; ++k) acc = acc + s.P[j][k] * bv[k];
        s.Pbp[j] = acc + s.p[j];
      }
    }
  }
  TEAM_SYNC();

  // columns of Y = [B'(P A) | B'Pb_p + r]; G = R + B'(P B) + reg I by entries
  TEAM_FOR(t) {
    TEAM_ITEMS(j, 13) {
      T col[12], row[12];
      load12(j < 12 ? s.PAt[j] : s.Pbp, col);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        load12(Bt + 12 * i, row);
        const T acc = dot12(row, col);
        s.Y[i][j] = j < 12 ? acc : acc + in[IN_RV + i];
      }
    }
    TEAM_ITEMS(e, 78) {
      int i, j;
      tri(e, i, j);
      T bi[12], pb[12];
      load12(Bt + 12 * i, bi);
      load12(s.Ht[j], pb);
      T gij = in[IN_R + e] + dot12(bi, pb);
      if (i == j) gij = gij + reg;
      s.L[e] = gij;
    }
  }
  TEAM_SYNC();

  // Ht = Y[:, :12]' (P B is spent), beside the factor's first column; the
  // Cholesky a row per member; the forward substitution a column per member
  TEAM_FOR(t) {
    for (int e = t; e < 144; e += W) s.Ht[e % 12][e / 12] = s.Y[e / 12][e % 12];
  }
  team_cholesky(s.L, s.dinv, lane, W, mask, rev);
  team_forward_subst(s.L, s.dinv, s.Y, lane, W, mask, rev);

  // back substitution a column per member; [K | k] = -X into Y
  TEAM_FOR(t) {
    TEAM_ITEMS(c, 13) {
      T y[12];
      back_subst_column(s.L, s.dinv, s.Y, c, y);
#pragma unroll
      for (int i = 0; i < 12; ++i) s.Y[i][c] = -y[i];
    }
  }
  TEAM_SYNC();

  // X = Q + A'PA + H'K by two rows of a column (into P transposed: P[j][i] =
  // X[i][j]), and p = q + A'Pb_p + H'k (column 12)
  TEAM_FOR(t) {
    TEAM_ITEMS(e, 78) {
      const int j = e / 6, i0 = 2 * (e % 6);
      T pa[12], kc[12], ai[12], hi[12];
      load12(j < 12 ? s.PAt[j] : s.Pbp, pa);
#pragma unroll
      for (int k = 0; k < 12; ++k) kc[k] = s.Y[k][j];
#pragma unroll
      for (int i = i0; i < i0 + 2; ++i) {
        load12(At + 12 * i, ai);
        load12(s.Ht[i], hi);
        const T a = dot12(ai, pa), h = dot12(hi, kc);
        if (j < 12) s.P[j][i] = (Q[12 * i + j] + a) + h;
        else s.p[i] = (in[IN_Q + i] + a) + h;
      }
    }
  }
  TEAM_SYNC();

  // P = (X + X') / 2, each entry pair by one member; with ACL (PAt and Pbp
  // are spent), Acl by 16 tiles of 3x3 entries and bcl by entries, each sum
  // over m = 0 ... 11 of B[i][m] [K | k][m][j] before A's or b's entry is
  // added (sqp_kernel.sqp_qp_backward_ref's mm(B, K) and mv(B, kv)); a
  // tile reads 3 + 3 words a step for its 9 products
  TEAM_FOR(t) {
    TEAM_ITEMS(e, 78) {
      int j, i;
      tri(e, j, i);  // i <= j
      const T sym = T(0.5) * (s.P[j][i] + s.P[i][j]);
      s.P[i][j] = sym;
      s.P[j][i] = sym;
    }
    if constexpr (ACL) {
      for (int q = t; q < 16; q += W) {
        const int i0 = 3 * (q / 4), j0 = 3 * (q % 4);
        T acc[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[r][c] = Bt[i0 + r] * s.Y[0][j0 + c];
        for (int m = 1; m < 12; ++m) {
          T bm[3], km[3];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            bm[r] = Bt[12 * m + i0 + r];  // B[i][m] = Bt[12 m + i]
            km[r] = s.Y[m][j0 + r];
          }
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[r][c] = acc[r][c] + bm[r] * km[c];
        }
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            s.PAt[i0 + r][j0 + c] = At[12 * (j0 + c) + i0 + r] + acc[r][c];
      }
      for (int i = t; i < 12; i += W) {
        T acc = Bt[i] * s.Y[0][12];
        for (int m = 1; m < 12; ++m) acc = acc + Bt[12 * m + i] * s.Y[m][12];
        s.Pbp[i] = in[IN_BV + i] + acc;
      }
    }
  }
}

}  // namespace k6t

#ifdef __CUDACC__

__global__ void riccati_fwd_kernel(const float* A, const float* Bm, const float* bv,
                                   const float* K, const float* k, const float* x0,
                                   float* x, float* u, int N, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k6::forward<float>(A, Bm, bv, K, k, x0, x, u, N, B, lane);
}

// stage inputs into shared memory without a register round trip
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// shared words of a block: [Q | Qf], the teams' arrays, two buffers of
// staged inputs
constexpr int team_smem_words(bool const_q) {
  return 288 + k6t::TEAMS * (720 + 2 * k6t::in_stride(const_q));
}

// the team kernels' body; ACL (K4a's split) also writes Acl [N,12,12,B] and
// bcl [N,12,B] beside K and k, the same way
template <bool CONST_Q, bool ACL>
__device__ __forceinline__ void team_backward(const float* A, const float* Bm,
                                              const float* bv, const float* Qw,
                                              const float* Qf, const float* R,
                                              const float* q, const float* r, float* K,
                                              float* k, float* Acl, float* bcl, int N,
                                              int B, float reg) {
  constexpr int W = k6t::W_CARD, TEAMS = k6t::TEAMS, THREADS = W * TEAMS;
  constexpr int S = k6t::in_stride(CONST_Q);
  // each thread copies rows r0, r0 + RSTEP, ... of its lane sc of the block
  constexpr int RSTEP = THREADS / TEAMS;
  static_assert(32 % W == 0 && THREADS % TEAMS == 0, "teams within warps");
  extern __shared__ float4 smem4[];
  __shared__ int rrow[78];  // R's row (12 i + j) of each staged lower entry
  float* qc = reinterpret_cast<float*>(smem4);
  auto* teams = reinterpret_cast<k6t::Team<float>*>(qc + 288);
  float* in = qc + 288 + TEAMS * 720;  // 2 buffers of TEAMS * S
  const int tid = threadIdx.x, team = tid / W, lane = tid % W;
  const int sc = tid % TEAMS, r0 = tid / TEAMS;
  const int b0 = blockIdx.x * TEAMS, b = b0 + team;
  const bool live = b < B, mine = b0 + sc < B;
  const size_t ln = (size_t)b0 + sc;
  const unsigned mask = srbd_team::team_mask(W, (tid & 31) / W);

  // stage g's rows of lane sc into its staged inputs in buf
  auto fetch = [&](int g, float* buf) {
    if (mine)
      k6t::stage_inputs<CONST_Q>(buf + sc * S, A, Bm, bv, Qw, R, q, r, rrow, g, B, ln, r0,
                                 RSTEP,
                                 [](float* d, const float* src) { cp_async4(d, src); });
    cp_async_commit();
  };
  // stage g's K and k (ACL: and Acl, bcl) of lane sc out of its team's array
  auto store = [&](int g) {
    if (!mine) return;
    const float(*y)[13] = teams[sc].Y;
    for (int row = r0; row < 144; row += RSTEP)
      K[((size_t)g * 144 + row) * B + ln] = y[row / 12][row % 12];
    for (int i = r0; i < 12; i += RSTEP) k[((size_t)g * 12 + i) * B + ln] = y[i][12];
    if constexpr (ACL) {
      const float(*a)[12] = teams[sc].PAt;
      for (int row = r0; row < 144; row += RSTEP)
        Acl[((size_t)g * 144 + row) * B + ln] = a[row / 12][row % 12];
      for (int i = r0; i < 12; i += RSTEP)
        bcl[((size_t)g * 12 + i) * B + ln] = teams[sc].Pbp[i];
    }
  };

  k6t::r_rows(rrow, tid, THREADS);
  if (CONST_Q)
    for (int i = tid; i < 288; i += THREADS) qc[i] = i < 144 ? Qw[i] : Qf[i - 144];
  __syncthreads();
  fetch(N - 1, in);
  if (live) k6t::seed<float, CONST_Q>(teams[team], qc, Qw, q, N, B, b, lane, W, false);
  for (int g = N - 1; g >= 0; --g) {
    float* cur = in + ((N - 1 - g) & 1) * TEAMS * S;
    cp_async_wait_all();
    __syncthreads();  // stage g's inputs are in; every team is done with g + 1
    if (g + 1 < N) store(g + 1);
    if (g > 0) fetch(g - 1, in + ((N - g) & 1) * TEAMS * S);
    __syncthreads();  // stage g + 1's K and k are out
    if (live)
      k6t::stage<float, CONST_Q, ACL>(teams[team], cur + team * S, qc, reg, lane, W, mask,
                                      false);
  }
  __syncthreads();
  store(0);
}

template <bool CONST_Q>
__global__ void __launch_bounds__(k6t::W_CARD* k6t::TEAMS, CONST_Q ? 4 : 3)
    riccati_team_kernel(const float* A, const float* Bm, const float* bv, const float* Qw,
                        const float* Qf, const float* R, const float* q, const float* r,
                        float* K, float* k, int N, int B, float reg) {
  team_backward<CONST_Q, false>(A, Bm, bv, Qw, Qf, R, q, r, K, k, nullptr, nullptr, N, B,
                                reg);
}

// K4a's split: K6a's team pass also writing Acl and bcl
__global__ void __launch_bounds__(k6t::W_CARD* k6t::TEAMS, 4)
    riccati_team_acl_kernel(const float* A, const float* Bm, const float* bv,
                            const float* Qw, const float* Qf, const float* R,
                            const float* q, const float* r, float* K, float* k,
                            float* Acl, float* bcl, int N, int B, float reg) {
  team_backward<true, true>(A, Bm, bv, Qw, Qf, R, q, r, K, k, Acl, bcl, N, B, reg);
}

template <bool CONST_Q>
static int launch_team(const float* A, const float* Bm, const float* bv, const float* Qw,
                       const float* Qf, const float* R, const float* q, const float* r,
                       float* K, float* k, int N, int B, float reg, cudaStream_t stream) {
  constexpr int bytes = team_smem_words(CONST_Q) * (int)sizeof(float);
  // the opt-in above 48 KB, on every launch: it holds per device context
  const cudaError_t err = cudaFuncSetAttribute(
      riccati_team_kernel<CONST_Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + k6t::TEAMS - 1) / k6t::TEAMS;
  riccati_team_kernel<CONST_Q><<<blocks, k6t::W_CARD * k6t::TEAMS, bytes, stream>>>(
      A, Bm, bv, Qw, Qf, R, q, r, K, k, N, B, reg);
  return (int)cudaGetLastError();
}

// K4a's team pass: K6a's (Qw, Qf the two 12x12 matrices), also writing Acl
// = A + B K [N,12,12,B] and bcl = b + B k [N,12,B]
extern "C" int srbd_riccati_bwd_team_acl_launch(const float* A, const float* Bm,
                                                const float* bv, const float* Qw,
                                                const float* Qf, const float* R,
                                                const float* q, const float* r, float* K,
                                                float* k, float* Acl, float* bcl, int N,
                                                int B, float reg, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  constexpr int bytes = team_smem_words(true) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      riccati_team_acl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + k6t::TEAMS - 1) / k6t::TEAMS;
  riccati_team_acl_kernel<<<blocks, k6t::W_CARD * k6t::TEAMS, bytes, (cudaStream_t)stream>>>(
      A, Bm, bv, Qw, Qf, R, q, r, K, k, Acl, bcl, N, B, reg);
  return (int)cudaGetLastError();
}

// K6a (const_q: Qw, Qf the two 12x12 matrices) and K6b (Qw = Q [N+1,12,12,B],
// Qf unused): the team kernel, one launch
extern "C" int srbd_riccati_bwd_team_launch(const float* A, const float* Bm, const float* bv,
                                            const float* Qw, const float* Qf, const float* R,
                                            const float* q, const float* r, float* K,
                                            float* k, int N, int B, float reg, int const_q,
                                            void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return const_q ? launch_team<true>(A, Bm, bv, Qw, Qf, R, q, r, K, k, N, B, reg, st)
                 : launch_team<false>(A, Bm, bv, Qw, Qf, R, q, r, K, k, N, B, reg, st);
}

extern "C" int srbd_riccati_fwd_launch(const float* A, const float* Bm, const float* bv,
                                       const float* K, const float* k, const float* x0,
                                       float* x, float* u, int N, int B, int threads,
                                       void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  riccati_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(A, Bm, bv, K, k, x0, x,
                                                                   u, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the per-team and per-scenario bodies over every lane,
       // in f64 (f32 under -DSRBD_HOST_F32)

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

// the team body over every lane: team, the team width it emulates (8 to 32;
// the card's is 16), rev: each team's members in reverse order within each
// step. Stages each lane's inputs as the card's block does.
template <bool CONST_Q, bool ACL = false>
static void team_host_lane(const host_t* A, const host_t* Bm, const host_t* bv,
                           const host_t* Qc, const host_t* R, const host_t* q,
                           const host_t* r, host_t* K, host_t* k, int N, int B, int b,
                           host_t reg, int W, bool rev, host_t* Acl = nullptr,
                           host_t* bcl = nullptr) {
  k6t::Team<host_t> s;
  host_t in[k6t::IN_QG + 144];
  int rrow[78];
  k6t::r_rows(rrow, 0, 1);
  k6t::seed<host_t, CONST_Q>(s, Qc, Qc, q, N, B, b, 0, W, rev);
  for (int g = N - 1; g >= 0; --g) {
    k6t::stage_inputs<CONST_Q>(in, A, Bm, bv, Qc, R, q, r, rrow, g, B, (size_t)b, 0, 1,
                               [](host_t* d, const host_t* src) { *d = *src; });
    k6t::stage<host_t, CONST_Q, ACL>(s, in, Qc, reg, 0, W, 0u, rev);
    for (int i = 0; i < 12; ++i) {
      for (int j = 0; j < 12; ++j) K[(((size_t)g * 12 + i) * 12 + j) * B + b] = s.Y[i][j];
      k[((size_t)g * 12 + i) * B + b] = s.Y[i][12];
      if (ACL) {
        for (int j = 0; j < 12; ++j)
          Acl[(((size_t)g * 12 + i) * 12 + j) * B + b] = s.PAt[i][j];
        bcl[((size_t)g * 12 + i) * B + b] = s.Pbp[i];
      }
    }
  }
}

extern "C" int srbd_riccati_bwd_team_host(int team, int rev, const host_t* A,
                                          const host_t* Bm, const host_t* bv,
                                          const host_t* Qc, const host_t* R,
                                          const host_t* q, const host_t* r, host_t* K,
                                          host_t* k, int N, int B, double reg, int const_q) {
  if (team < 8 || team > 32) return 1;
  const host_t rg(reg);
  for (int b = 0; b < B; ++b) {
    if (const_q)
      team_host_lane<true>(A, Bm, bv, Qc, R, q, r, K, k, N, B, b, rg, team, rev != 0);
    else
      team_host_lane<false>(A, Bm, bv, Qc, R, q, r, K, k, N, B, b, rg, team, rev != 0);
  }
  return 0;
}

// K4a's team pass over every lane (Qc = [Q | Qf]), as the team entry above,
// also writing Acl and bcl
extern "C" int srbd_riccati_bwd_team_acl_host(int team, int rev, const host_t* A,
                                              const host_t* Bm, const host_t* bv,
                                              const host_t* Qc, const host_t* R,
                                              const host_t* q, const host_t* r, host_t* K,
                                              host_t* k, host_t* Acl, host_t* bcl, int N,
                                              int B, double reg) {
  if (team < 8 || team > 32) return 1;
  const host_t rg(reg);
  for (int b = 0; b < B; ++b)
    team_host_lane<true, true>(A, Bm, bv, Qc, R, q, r, K, k, N, B, b, rg, team, rev != 0,
                               Acl, bcl);
  return 0;
}

extern "C" int srbd_riccati_fwd_host_f64(const host_t* A, const host_t* Bm,
                                         const host_t* bv, const host_t* K,
                                         const host_t* k, const host_t* x0, host_t* x,
                                         host_t* u, int N, int B) {
  for (int lane = 0; lane < B; ++lane)
    k6::forward<host_t>(A, Bm, bv, K, k, x0, x, u, N, B, lane);
  return 0;
}

#endif
