// K3s · the dense one-pass SQP trip (K3a at the candidate, K3b at the
// iterate) as three launches:
//
//   K3s-A  k3s_planes_kernel<CAND>   the plane pass, one thread per
//                                    (stage, lane);
//   K3s-B  k1s_riccati_team_kernel   the backward Riccati pass, K1's
//                                    team of 16 threads per scenario, as
//                                    sqp_planes.cu builds it and launched
//                                    through its srbd_k1s_riccati_launch
//                                    (no copy here);
//   K3s-C  k3s_rollout_kernel        the closed-loop rollout, dphi and the
//                                    merit's reduction over the stages, one
//                                    thread per lane.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/sqp_pallas.py::_onepass_kernel
// (:492, called at :862; K3b, CAND = false) and ::_onepass_cand_kernel
// (:574, called at :749; K3a, CAND = true). Contract: the plain versions
// srbd_nmpc_tpu_torch/ops/sqp_kernel.py::sqp_qp_solve_onepass_ref and
// ::sqp_qp_solve_onepass_cand_ref. The stage code is k3_stage.cuh's.
//
// What bounds it on the H100: in one thread per scenario, the stage's
// linearization, the 12x12 Riccati stage, the closed-loop
// products and the merit are live together: 255 registers and ~9.7 KB of
// spills per thread, and the dense Acl [N,12,12,B] written only to be read
// back by the rollout (1.5 GB per call at B=131072; PERF.md). Split, the plane pass
// and the rollout are bound by the bytes they move (the pack, K, the
// inputs), and the Riccati pass by the instructions a team executes per stage
// and by shared memory (K1s's note, sqp_planes.cu). The bytes of the
// split (6.5-6.8 GB per call at B=131072, chip_smoke.py's _k3_split_bytes)
// put a floor of ~2 ms under it at 3.35 TB/s, above the operation bound of
// the work itself.
//
// What this design does about it:
// - The plane pass holds no P. Each (stage, lane) thread runs the stage
//   code (k3::stage_terms: srbd_soa's Jacobian blocks and
//   four-call RK4, the constraint rows and barrier, Ru, q and r_eff), and
//   row N the terminal stage (k3::terminal_stage). It writes K1's 87-channel
//   pack [N, 87, B] in K1's channel order (D1, D2 row-major), so that the
//   team Riccati pass reads it as it is; the stage's four merit scalars
//   [N, 4, B] (0.5 |b|^2, the stage's phi term, max |b|, min constraint),
//   each formed by merit_accumulate itself from a seed that adds nothing
//   (theta +0 before a term >= 0, phi -0, whose sum with any x is x); and
//   the terminal rows [13, B] (qN, eN'qN).
// - The Riccati pass is K1s-B unchanged: seeded by P = Qf and p = qN, it
//   parks K [N,12,12,B] and kv [N,12,B] = -Y.
// - The rollout forms Acl and bcl in registers, column by column, from the
//   pack and K, kv (k3::closed_loop_column), and sums each row over the 12 columns left to right,
//   structural zeros included, as closed_loop_rollout does: Acl is written
//   nowhere. The merit scalars are reduced over k = N-1 ... 0 from
//   merit_seed(0.5 eN'qN), merit_accumulate's order. dx, du, dphi, theta,
//   phi, max|defect| and min constraint are bit for bit those of one thread
//   per scenario walking the same stages.
// No operation crosses scenarios, so a compacted launch gives bitwise the
// full-width result.
//
// Built with -fmad=false like every source (utils/build.py). The per-lane
// bodies compile as host C++ (without __CUDACC__): the host entry runs the
// three passes over every lane, each team of the Riccati pass emulated with
// its members one after another (k1s::riccati_team's host path, widths 8 to
// 32, in either order), so that tests hold it to the plain version (f64) and
// its f32 build (-DSRBD_HOST_F32) to stored digests of its outputs without a
// card.

#include "k3_stage.cuh"
#include "k1s_passes.cuh"

namespace k3s {

using namespace srbd_dev;

// the merit scalars of a stage [N, MS_C, B] (as ops/sqp_kernel.py::MERIT_C)
constexpr int MS_TH = 0, MS_PH = 1, MS_MD = 2, MS_MC = 3, MS_C = 4;

// ---------------------------------------------------------------------------
// K3s-A: stage k < N of one lane, or the terminal stage (k == N)
// ---------------------------------------------------------------------------
template <typename T, bool CAND>
HD void plane_stage(const T* kc, const T* xa, const T* us, const T* xr, const T* dxc,
                    const T* duc, const T* alpha, T* pack, T* mer, T* term, int N, int B,
                    int k, int b, T mu_b, T theta_b) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const T a = CAND ? alpha[b] : T(0);
  if (k == N) {
    T xn[12], qN[12], sN;
    k3::terminal_stage<T, CAND>(kc, xa, dxc, xr, a, N, B, b, xn, qN, sN);
#pragma unroll
    for (int i = 0; i < 12; ++i) AT(term, i) = qN[i];
    AT(term, k1s::T_PN) = sN;
    return;
  }
  const Model<T> md = load_model(kc);
  T x[12], u[12], e[12], xn[12];
  k3::load_stage<T, CAND>(xa, dxc, a, k, B, b, x);
  k3::load_stage<T, CAND>(xa, dxc, a, k + 1, B, b, xn);
  k3::load_stage<T, CAND>(us, duc, a, k, B, b, u);
#pragma unroll
  for (int i = 0; i < 12; ++i) e[i] = x[i] - AT(xr, k * 12 + i);
  M3<T> D1, D2;
  T sF[3], sr[3], sl[3], bv[12], con[24], bb[24], ddb[24], Ru[12], q[12], rf[12];
  k3::stage_terms(md, kc, mu_b, theta_b, k_log(theta_b), x, u, e, xn, D1, D2, sF, sr, sl,
                  bv, con, bb, ddb, Ru, q, rf);

  T* pk = pack + (size_t)k * k1::P_C * B;
#define PK(c) pk[(size_t)(c) * B + b]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      PK(k1::P_D1 + 3 * i + j) = D1.m[i][j];
      PK(k1::P_D2 + 3 * i + j) = D2.m[i][j];
    }
    PK(k1::P_SF + i) = sF[i];
    PK(k1::P_SR + i) = sr[i];
    PK(k1::P_SL + i) = sl[i];
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    PK(k1::P_B + i) = bv[i];
    PK(k1::P_Q + i) = q[i];
    PK(k1::P_RF + i) = rf[i];
  }
#pragma unroll
  for (int g = 0; g < 24; ++g) PK(k1::P_DDB + g) = ddb[g];
#undef PK

  // the stage's terms of the merit, as merit_accumulate adds them
  Merit<T> m = merit_seed(T(-0.0));
  merit_accumulate(m, bv, con, bb, u, Ru, e, q);
  T* mk = mer + (size_t)k * MS_C * B;
  mk[(size_t)MS_TH * B + b] = m.th;
  mk[(size_t)MS_PH * B + b] = m.ph;
  mk[(size_t)MS_MD * B + b] = m.md;
  mk[(size_t)MS_MC * B + b] = m.mc;
#undef AT
}

// ---------------------------------------------------------------------------
// K3s-C: closed_loop_rollout with Acl and bcl formed from the pack and the
// parked gains, then the merit in backward stage order
// ---------------------------------------------------------------------------
template <typename T>
HD void rollout(const T* kc, const T* pack, const T* mer, const T* term, const T* Kp,
                const T* kvp, const T* dx0, T* dx_out, T* du_out, T* dphi_out,
                T* theta_out, T* phi_out, T* maxdef_out, T* mincon_out, int N, int B,
                int b) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
#define PK(c) pk[(size_t)(c) * B + b]
  const T dt = kc[k1::K_DT];
  const T m_inv = T(1) / kc[k1::K_MASS];
  const T dtm = dt * m_inv;
  T dx[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) dx[i] = AT(dx0, i);
  T tot = 0;
  for (int k = 0; k < N; ++k) {
    const T* pk = pack + (size_t)k * k1::P_C * B;
    T D1[3][3], D2[3][3], sF[3], sr[3], sl[3], bv[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        D1[i][j] = PK(k1::P_D1 + 3 * i + j);
        D2[i][j] = PK(k1::P_D2 + 3 * i + j);
      }
      sF[i] = PK(k1::P_SF + i);
      sr[i] = PK(k1::P_SR + i);
      sl[i] = PK(k1::P_SL + i);
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) bv[i] = PK(k1::P_B + i);

    // du = K dx + kv and dxn = Acl dx + bcl, column j of [K | kv] and of
    // [Acl | bcl] at a time; each row's sum left to right over j
    T du[12], dxn[12];
#pragma unroll
    for (int j = 0; j < 13; ++j) {
      T y[12], col[12];
#pragma unroll
      for (int i = 0; i < 12; ++i)
        y[i] = (j < 12) ? AT(Kp, (k * 12 + i) * 12 + j) : AT(kvp, k * 12 + i);
      k3::closed_loop_column(D1, D2, sF, sr, sl, bv, y, j, dt, dtm, col);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (j == 0) {
          du[i] = y[i] * dx[0];
          dxn[i] = col[i] * dx[0];
        } else if (j < 12) {
          du[i] = du[i] + y[i] * dx[j];
          dxn[i] = dxn[i] + col[i] * dx[j];
        } else {
          du[i] = du[i] + y[i];
          dxn[i] = dxn[i] + col[i];
        }
      }
    }
    T px = dx[0] * PK(k1::P_Q);
    T pu = du[0] * PK(k1::P_RF);
#pragma unroll
    for (int i = 1; i < 12; ++i) {
      px = px + dx[i] * PK(k1::P_Q + i);
      pu = pu + du[i] * PK(k1::P_RF + i);
    }
    tot = (k == 0) ? px + pu : tot + (px + pu);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      AT(du_out, k * 12 + i) = du[i];
      AT(dx_out, k * 12 + i) = dxn[i];
      dx[i] = dxn[i];
    }
  }
  T last = dx[0] * AT(term, 0);
#pragma unroll
  for (int i = 1; i < 12; ++i) last = last + dx[i] * AT(term, i);
  AT(dphi_out, 0) = tot + last;

  Merit<T> m = merit_seed(T(0.5) * AT(term, k1s::T_PN));
  for (int k = N - 1; k >= 0; --k) {
    const T* mk = mer + (size_t)k * MS_C * B;
    m.th = m.th + mk[(size_t)MS_TH * B + b];
    m.ph = m.ph + mk[(size_t)MS_PH * B + b];
    m.md = nan_max(m.md, mk[(size_t)MS_MD * B + b]);
    m.mc = nan_min(m.mc, mk[(size_t)MS_MC * B + b]);
  }
  AT(theta_out, 0) = m.th;
  AT(phi_out, 0) = m.ph;
  AT(maxdef_out, 0) = m.md;
  AT(mincon_out, 0) = m.mc;
#undef PK
#undef AT
}

}  // namespace k3s

#ifdef __CUDACC__

// the constants block into shared memory, for the whole block
#define K3S_CONSTS                                                  \
  __shared__ float kc[k3::K_LEN];                                   \
  for (int i = threadIdx.x; i < k3::K_LEN; i += blockDim.x) kc[i] = consts[i]; \
  __syncthreads();

template <bool CAND>
__global__ void __launch_bounds__(128, 3)
    k3s_planes_kernel(const float* __restrict__ consts, const float* xa, const float* us,
                      const float* xr, const float* dxc, const float* duc,
                      const float* alpha, float* pack, float* mer, float* term, int N,
                      int B, float mu_b, float theta_b) {
  K3S_CONSTS
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k3s::plane_stage<float, CAND>(kc, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B,
                                blockIdx.y, b, mu_b, theta_b);
}

__global__ void __launch_bounds__(128)
    k3s_rollout_kernel(const float* __restrict__ consts, const float* pack, const float* mer,
                       const float* term, const float* park0, const float* park1,
                       const float* dx0, float* dx_out, float* du_out, float* dphi,
                       float* theta, float* phi, float* maxdef, float* mincon, int N,
                       int B) {
  K3S_CONSTS
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k3s::rollout<float>(kc, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
                      phi, maxdef, mincon, N, B, b);
}

constexpr int K3S_THREADS = 128;

// K3s-A: pack [N, 87, B], mer [N, 4, B], term [13, B]; cand != 0: K3a
// (dxc, duc, alpha read), cand == 0: K3b (they may be null)
extern "C" int srbd_k3s_planes_launch(const float* consts, const float* xa, const float* us,
                                      const float* xr, const float* dxc, const float* duc,
                                      const float* alpha, float* pack, float* mer,
                                      float* term, int N, int B, float mu_b, float theta_b,
                                      int cand, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((B + K3S_THREADS - 1) / K3S_THREADS, N + 1);
  if (cand)
    k3s_planes_kernel<true><<<grid, K3S_THREADS, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, mu_b, theta_b);
  else
    k3s_planes_kernel<false><<<grid, K3S_THREADS, 0, (cudaStream_t)stream>>>(
        consts, xa, us, xr, dxc, duc, alpha, pack, mer, term, N, B, mu_b, theta_b);
  return (int)cudaGetLastError();
}

// K3s-C: dx_out = dx[1:]; park0, park1: K and kv from K1s-B
extern "C" int srbd_k3s_rollout_launch(const float* consts, const float* pack,
                                       const float* mer, const float* term,
                                       const float* park0, const float* park1,
                                       const float* dx0, float* dx_out, float* du_out,
                                       float* dphi, float* theta, float* phi, float* maxdef,
                                       float* mincon, int N, int B, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k3s_rollout_kernel<<<(B + K3S_THREADS - 1) / K3S_THREADS, K3S_THREADS, 0,
                       (cudaStream_t)stream>>>(consts, pack, mer, term, park0, park1, dx0,
                                               dx_out, du_out, dphi, theta, phi, maxdef,
                                               mincon, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the three passes over every lane

using srbd_dev::host_t;

// the arguments of the three launches together; team: the team width the
// Riccati pass emulates (8 to 32; the card's is k1s::W_CARD), rev: the
// team's members in reverse order within each step
extern "C" int srbd_sqp_onepass_split_host(int team, int rev, int cand, const host_t* consts,
                                           const host_t* xa, const host_t* us,
                                           const host_t* xr, const host_t* dxc,
                                           const host_t* duc, const host_t* alpha,
                                           const host_t* dx0, host_t* dx_out,
                                           host_t* du_out, host_t* dphi, host_t* theta,
                                           host_t* phi, host_t* maxdef, host_t* mincon,
                                           host_t* pack, host_t* mer, host_t* term,
                                           host_t* park0, host_t* park1, int N, int B,
                                           double mu_b, double theta_b, double reg) {
  if (team < 8 || team > 32) return 1;  // the team's x0: two columns a member
  const host_t mu(mu_b), th(theta_b), rg(reg);
  for (int k = 0; k <= N; ++k)
    for (int b = 0; b < B; ++b) {
      if (cand)
        k3s::plane_stage<host_t, true>(consts, xa, us, xr, dxc, duc, alpha, pack, mer, term,
                                       N, B, k, b, mu, th);
      else
        k3s::plane_stage<host_t, false>(consts, xa, us, xr, dxc, duc, alpha, pack, mer,
                                        term, N, B, k, b, mu, th);
    }
  host_t rc[k1s::RC_LEN];
  for (int i = 0; i < k1s::RC_LEN; ++i) rc[i] = k1s::rc_word(consts, i);
  for (int b = 0; b < B; ++b) {
    k1s::Team<host_t> s;
    k1s::riccati_team(s, consts, rc, pack, term, park0, park1, N, B, b, rg, 0, team, 0u,
                      rev != 0);
  }
  for (int b = 0; b < B; ++b)
    k3s::rollout(consts, pack, mer, term, park0, park1, dx0, dx_out, du_out, dphi, theta,
                 phi, maxdef, mincon, N, B, b);
  return 0;
}

#endif
