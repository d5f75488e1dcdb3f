// K4a / K4b · two-pass fused SQP QP solve (dense), one thread per scenario.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/sqp_pallas.py::_bwd_kernel (K4a)
// and ::_fwd_kernel (K4b), the two pallas_calls of sqp_qp_solve. Contract: the
// plain PyTorch versions srbd_nmpc_tpu_torch/ops/sqp_kernel.py::
// sqp_qp_backward_ref and ::sqp_qp_forward_ref. No engine route runs it: it is
// the two-pass oracle the one-pass kernels (K3) are held against, and the
// "twopass" variant of the JAX tools.
//
// K4a, stages k = N-1 ... 0: the dense Euler sensitivities A = I + dt J_fx,
// B = dt J_fu (srbd_soa.euler_AB, K5's order), the four-call RK4 defect, the
// relaxed barrier through the full Ac [24,12] (R_eff = R + Ac' diag(ddb) Ac), a
// dense Riccati stage in K6's rounding order (G = R_eff + B'PB + reg I not
// symmetrized, right-looking Cholesky with dinv = rsqrt(pivot), K and kv from
// one 13-column solve, P <- (P_new + P_new') / 2), and the merit accumulated in
// backward stage order. It writes Acl = A + B K, K, bcl = b + B kv, kv, q,
// r_eff per stage, q_N and the merit. K4b rolls dx_{k+1} = Acl dx_k + bcl,
// du_k = K dx_k + kv forward and forms dphi (srbd_dev.cuh, shared with K3).
//
// What bounds it on the H100: K4a in one thread per scenario
// (sqp_twopass_bwd_kernel, kept as the yardstick) is latency- and
// register-bound like K6's one-thread body (dense 12x12 products on P, P A,
// H, the factor and the 13-column right-hand side, plus A and B, all
// spilled); it writes 1,344 bytes per stage and scenario. K4b reads those
// back once: bound by bytes. Every global array is indexed (row * B + lane),
// so consecutive threads touch consecutive addresses. Full-precision math,
// -fmad=false, the plain version's sum order.
//
// What the split K4a does about it (ops/sqp_kernel.py::_k4a_split, four
// launches of kernels that other paths already run, each rounding as this
// body does): K5's stage pass and dense write (linearize.cu) write A, B,
// R_eff, b, q and r_eff straight into K4a's buffers, with K5's merit rows;
// k4s_merit_kernel here, a thread per lane, forms q_N into row N of the
// q buffer and reduces the merit over k = N-1 ... 0 from K5's rows in
// merit_accumulate's grouping; K6a's team pass (riccati.cu
// riccati_team_acl_kernel, K6a's kernel with a compile-time flag) runs the
// stage over shared memory, a team of 16 per scenario, and also forms
// Acl = A + B K and bcl = b + B kv, which the block writes beside K and k.
// The split moves more bytes than this body (A, B, R_eff go through device
// memory: ~13.8 GB a call at N=20, B=131072 against ~3.9 GB) and is bound
// by K6a's team pass.

#include "srbd_dev.cuh"

namespace k4 {

using namespace srbd_dev;

// constants block (offsets match ops/sqp_kernel.py::_K4_*): mass, dt, Iinv[9],
// foot[6], then Ac [24,12], bc [24], R, Q, Qf [12,12]
constexpr int K_AC = 17, K_BC = 305, K_R = 329, K_Q = 473, K_QF = 617, K_LEN = 761;

template <typename T>
HD void backward(const T* kc, const T* xa, const T* us, const T* xr, T* Aclp, T* Kp, T* bclp,
                 T* kvp, T* qp, T* rfp, T* qNp, T* theta_out, T* phi_out, T* maxdef_out,
                 T* mincon_out, int N, int B, int b, T mu_b, T theta_b, T reg) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const Model<T> md = load_model(kc);
  const T dt = md.dt;
  const T inv_m = T(1) / md.mass;
  const T* Ac = kc + K_AC;  // [24, 12]
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T* Qf = kc + K_QF;
  const T log_th = k_log(theta_b);

  // terminal stage: Riccati seed (P, p) = (Qf, qN) and phi_N
  T P[12][12], p[12], xn[12], eN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    xn[i] = AT(xa, N * 12 + i);
    eN[i] = xn[i] - AT(xr, N * 12 + i);
  }
  T sN = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Qf[12 * i] * eN[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
    AT(qNp, i) = acc;
    p[i] = acc;
    sN = (i == 0) ? eN[0] * acc : sN + eN[i] * acc;
#pragma unroll
    for (int j = 0; j < 12; ++j) P[i][j] = Qf[12 * i + j];
  }
  Merit<T> mer = merit_seed(T(0.5) * sN);

  for (int k = N - 1; k >= 0; --k) {
    // ---- linearization: dense A, B; defect; barrier; R_eff, r_eff, q -------
    T x[12], u[12], e[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      x[i] = AT(xa, k * 12 + i);
      u[i] = AT(us, k * 12 + i);
      e[i] = x[i] - AT(xr, k * 12 + i);
    }
    M3<T> D1, D2;
    T sF[3], sr[3], sl[3];
    soa_jacobian_blocks(md, x, u, D1, D2, sF, sr, sl);
    T A[12][12], Bm[12][12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        A[i][j] = T(i == j ? 1 : 0) + dt * jfx(D1, D2, sF, i, j);
        Bm[i][j] = dt * jfu(sr, sl, inv_m, i, j);
      }
    T bv[12];
    soa_rk4(md, x, u, bv);
#pragma unroll
    for (int i = 0; i < 12; ++i) bv[i] = bv[i] - xn[i];

    T con[24], bb[24], db[24], ddb[24];
#pragma unroll
    for (int r = 0; r < 24; ++r) {
      T c = Ac[12 * r] * u[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) c = c + Ac[12 * r + j] * u[j];
      con[r] = c + bc[r];
      barrier(con[r], mu_b, theta_b, log_th, bb[r], db[r], ddb[r]);
    }
    T Ru[12], q[12], rf[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T ri = Rw[12 * i] * u[0];
      T qi = Qw[12 * i] * e[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) {
        ri = ri + Rw[12 * i + j] * u[j];
        qi = qi + Qw[12 * i + j] * e[j];
      }
      T ad = Ac[i] * db[0];
#pragma unroll
      for (int r = 1; r < 24; ++r) ad = ad + Ac[12 * r + i] * db[r];
      Ru[i] = ri;
      q[i] = qi;
      rf[i] = ri + ad;
    }

    // ---- dense Riccati stage (K6's order) --------------------------------
    // PA = P A
    T PA[12][12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        T acc = P[i][0] * A[0][j];
#pragma unroll
        for (int m = 1; m < 12; ++m) acc = acc + P[i][m] * A[m][j];
        PA[i][j] = acc;
      }

    // G = R_eff + B'(P B) + reg I, lower triangle, one column of P B at a time
    T L[12][12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T pb[12];
#pragma unroll
      for (int m = 0; m < 12; ++m) {
        T acc = P[m][0] * Bm[0][j];
#pragma unroll
        for (int n = 1; n < 12; ++n) acc = acc + P[m][n] * Bm[n][j];
        pb[m] = acc;
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (i < j) continue;
        T re = Ac[i] * (Ac[j] * ddb[0]);
#pragma unroll
        for (int r = 1; r < 24; ++r) re = re + Ac[12 * r + i] * (Ac[12 * r + j] * ddb[r]);
        T acc = Bm[0][i] * pb[0];
#pragma unroll
        for (int m = 1; m < 12; ++m) acc = acc + Bm[m][i] * pb[m];
        T gij = (Rw[12 * i + j] + re) + acc;
        if (i == j) gij = gij + reg;
        L[i][j] = gij;
      }
    }

    // H = B'(P A); Pb_p = P b + p; Y = [H | B' Pb_p + r_eff]
    T H[12][12], Pbp[12], Y[12][13];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = P[i][0] * bv[0];
#pragma unroll
      for (int m = 1; m < 12; ++m) acc = acc + P[i][m] * bv[m];
      Pbp[i] = acc + p[i];
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        T acc = Bm[0][i] * PA[0][j];
#pragma unroll
        for (int m = 1; m < 12; ++m) acc = acc + Bm[m][i] * PA[m][j];
        H[i][j] = acc;
        Y[i][j] = acc;
      }
      T acc = Bm[0][i] * Pbp[0];
#pragma unroll
      for (int m = 1; m < 12; ++m) acc = acc + Bm[m][i] * Pbp[m];
      Y[i][12] = acc + rf[i];
    }

    // right-looking Cholesky on the lower triangle, dinv = rsqrt(pivot)
    T dinv[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const T di = k_rsqrt(L[j][j]);
      dinv[j] = di;
#pragma unroll
      for (int i = 0; i < 12; ++i)
        if (i >= j) L[i][j] = L[i][j] * di;
#pragma unroll
      for (int c = 0; c < 12; ++c)
#pragma unroll
        for (int i = 0; i < 12; ++i)
          if (c > j && i >= c) L[i][c] = L[i][c] - L[i][j] * L[c][j];
    }

    // (L L') X = Y: forward then backward substitution, 13 columns
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int c = 0; c < 13; ++c) Y[i][c] = Y[i][c] * dinv[i];
#pragma unroll
      for (int r = 0; r < 12; ++r)
        if (r > i) {
#pragma unroll
          for (int c = 0; c < 13; ++c) Y[r][c] = Y[r][c] - L[r][i] * Y[i][c];
        }
    }
#pragma unroll
    for (int i = 11; i >= 0; --i) {
#pragma unroll
      for (int c = 0; c < 13; ++c) Y[i][c] = Y[i][c] * dinv[i];
#pragma unroll
      for (int r = 0; r < 12; ++r)
        if (r < i) {
#pragma unroll
          for (int c = 0; c < 13; ++c) Y[r][c] = Y[r][c] - L[i][r] * Y[i][c];
        }
    }

    // [K | kv] = -X, parked with q and r_eff
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int c = 0; c < 13; ++c) Y[i][c] = -Y[i][c];
#pragma unroll
      for (int j = 0; j < 12; ++j) AT(Kp, (k * 12 + i) * 12 + j) = Y[i][j];
      AT(kvp, k * 12 + i) = Y[i][12];
      AT(qp, k * 12 + i) = q[i];
      AT(rfp, k * 12 + i) = rf[i];
    }

    // Acl = A + B K, bcl = b + B kv
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j < 13; ++j) {
        T acc = Bm[i][0] * Y[0][j];
#pragma unroll
        for (int m = 1; m < 12; ++m) acc = acc + Bm[i][m] * Y[m][j];
        if (j < 12)
          AT(Aclp, (k * 12 + i) * 12 + j) = A[i][j] + acc;
        else
          AT(bclp, k * 12 + i) = bv[i] + acc;
      }
    }

    // P_new = Q + A'(P A) + H'K (into PA, column by column); p = q + A'Pb_p + H'kv
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T col[12];
#pragma unroll
      for (int m = 0; m < 12; ++m) col[m] = PA[m][j];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        T a = A[0][i] * col[0];
#pragma unroll
        for (int m = 1; m < 12; ++m) a = a + A[m][i] * col[m];
        T h = H[0][i] * Y[0][j];
#pragma unroll
        for (int m = 1; m < 12; ++m) h = h + H[m][i] * Y[m][j];
        PA[i][j] = (Qw[12 * i + j] + a) + h;
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T a = A[0][i] * Pbp[0];
#pragma unroll
      for (int m = 1; m < 12; ++m) a = a + A[m][i] * Pbp[m];
      T h = H[0][i] * Y[0][12];
#pragma unroll
      for (int m = 1; m < 12; ++m) h = h + H[m][i] * Y[m][12];
      p[i] = (q[i] + a) + h;
    }
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) P[i][j] = T(0.5) * (PA[i][j] + PA[j][i]);

    // ---- merit at the current iterate, backward stage order ---------------
    merit_accumulate(mer, bv, con, bb, u, Ru, e, q);
#pragma unroll
    for (int i = 0; i < 12; ++i) xn[i] = x[i];
  }
  AT(theta_out, 0) = mer.th;
  AT(phi_out, 0) = mer.ph;
  AT(maxdef_out, 0) = mer.md;
  AT(mincon_out, 0) = mer.mc;
}

// K4a's split, its terminal-and-merit pass for one lane (Qf row-major):
// qN = Qf eN into row N of q [N+1, 12, B], phi_N, and the merit from K5's
// per-stage rows (mer [N, 8, B]: 1/2 |b|^2, barrier sum, min constraint,
// max |b|, 1/2 u'Ru, 1/2 ex'q) accumulated over k = N-1 ... 0 as
// merit_accumulate groups them: theta + mer0, phi + ((mer1 + mer4) + mer5)
template <typename T>
HD void merit_pass(const T* Qf, const T* xa, const T* xr, const T* mer, T* q, T* theta_out,
                   T* phi_out, T* maxdef_out, T* mincon_out, int N, int B, int b) {
  T eN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) eN[i] = AT(xa, N * 12 + i) - AT(xr, N * 12 + i);
  T sN = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Qf[12 * i] * eN[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
    AT(q, N * 12 + i) = acc;
    sN = (i == 0) ? eN[0] * acc : sN + eN[i] * acc;
  }
  Merit<T> m = merit_seed(T(0.5) * sN);
  for (int k = N - 1; k >= 0; --k) {
    const T* mk = mer + (size_t)k * 8 * B;
    m.th = m.th + AT(mk, 0);
    m.ph = m.ph + ((AT(mk, 1) + AT(mk, 4)) + AT(mk, 5));
    m.md = nan_max(m.md, AT(mk, 3));
    m.mc = nan_min(m.mc, AT(mk, 2));
  }
  AT(theta_out, 0) = m.th;
  AT(phi_out, 0) = m.ph;
  AT(maxdef_out, 0) = m.md;
  AT(mincon_out, 0) = m.mc;
}

// K4b: the rollout of K4a's products from dx_0
template <typename T>
HD void forward(const T* Acl, const T* Kp, const T* bcl, const T* kv, const T* q,
                const T* rf, const T* qNp, const T* dx0, T* dx_out, T* du_out, T* dphi,
                int N, int B, int b) {
  T dx[12], qN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    dx[i] = AT(dx0, i);
    qN[i] = AT(qNp, i);
  }
  AT(dphi, 0) = closed_loop_rollout(Acl, Kp, bcl, kv, q, rf, qN, dx, dx_out, du_out, N, B, b);
#undef AT
}

}  // namespace k4

#ifdef __CUDACC__

__global__ void sqp_twopass_bwd_kernel(const float* __restrict__ consts, const float* xa,
                                       const float* us, const float* xr, float* Acl, float* K,
                                       float* bcl, float* kv, float* q, float* rf, float* qN,
                                       float* theta, float* phi, float* maxdef,
                                       float* mincon, int N, int B, float mu_b,
                                       float theta_b, float reg) {
  __shared__ float kc[k4::K_LEN];
  for (int i = threadIdx.x; i < k4::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k4::backward<float>(kc, xa, us, xr, Acl, K, bcl, kv, q, rf, qN, theta, phi, maxdef, mincon,
                      N, B, b, mu_b, theta_b, reg);
}

__global__ void sqp_twopass_fwd_kernel(const float* Acl, const float* K, const float* bcl,
                                       const float* kv, const float* q, const float* rf,
                                       const float* qN, const float* dx0, float* dx_out,
                                       float* du_out, float* dphi, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k4::forward<float>(Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B, b);
}

__global__ void __launch_bounds__(128)
    k4s_merit_kernel(const float* __restrict__ consts, const float* xa, const float* xr,
                     const float* mer, float* q, float* theta, float* phi, float* maxdef,
                     float* mincon, int N, int B) {
  __shared__ float qf[144];
  for (int i = threadIdx.x; i < 144; i += blockDim.x) qf[i] = consts[k4::K_QF + i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k4::merit_pass<float>(qf, xa, xr, mer, q, theta, phi, maxdef, mincon, N, B, b);
}

// K4a's split, its terminal-and-merit pass: qN into q [N+1, 12, B] row N,
// the merit from K5's rows mer [N, 8, B]
extern "C" int srbd_k4s_merit_launch(const float* consts, const float* xa, const float* xr,
                                     const float* mer, float* q, float* theta, float* phi,
                                     float* maxdef, float* mincon, int N, int B,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  k4s_merit_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      consts, xa, xr, mer, q, theta, phi, maxdef, mincon, N, B);
  return (int)cudaGetLastError();
}

extern "C" int srbd_sqp_twopass_bwd_launch(const float* consts, const float* xa,
                                           const float* us, const float* xr, float* Acl,
                                           float* K, float* bcl, float* kv, float* q,
                                           float* rf, float* qN, float* theta, float* phi,
                                           float* maxdef, float* mincon, int N, int B,
                                           float mu_b, float theta_b, float reg, int threads,
                                           void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  sqp_twopass_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      consts, xa, us, xr, Acl, K, bcl, kv, q, rf, qN, theta, phi, maxdef, mincon, N, B, mu_b,
      theta_b, reg);
  return (int)cudaGetLastError();
}

extern "C" int srbd_sqp_twopass_fwd_launch(const float* Acl, const float* K, const float* bcl,
                                           const float* kv, const float* q, const float* rf,
                                           const float* qN, const float* dx0, float* dx_out,
                                           float* du_out, float* dphi, int N, int B,
                                           int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  sqp_twopass_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B);
  return (int)cudaGetLastError();
}

#else  // host build: the same per-scenario bodies over every lane, in f64

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

extern "C" int srbd_sqp_twopass_bwd_host_f64(const host_t* consts, const host_t* xa,
                                             const host_t* us, const host_t* xr, host_t* Acl,
                                             host_t* K, host_t* bcl, host_t* kv, host_t* q,
                                             host_t* rf, host_t* qN, host_t* theta,
                                             host_t* phi, host_t* maxdef, host_t* mincon,
                                             int N, int B, double mu_b, double theta_b,
                                             double reg) {
  for (int b = 0; b < B; ++b)
    k4::backward<host_t>(consts, xa, us, xr, Acl, K, bcl, kv, q, rf, qN, theta, phi, maxdef,
                         mincon, N, B, b, mu_b, theta_b, reg);
  return 0;
}

extern "C" int srbd_k4s_merit_host(const host_t* consts, const host_t* xa, const host_t* xr,
                                   const host_t* mer, host_t* q, host_t* theta, host_t* phi,
                                   host_t* maxdef, host_t* mincon, int N, int B) {
  for (int b = 0; b < B; ++b)
    k4::merit_pass<host_t>(consts + k4::K_QF, xa, xr, mer, q, theta, phi, maxdef, mincon, N,
                           B, b);
  return 0;
}

extern "C" int srbd_sqp_twopass_fwd_host_f64(const host_t* Acl, const host_t* K,
                                             const host_t* bcl, const host_t* kv,
                                             const host_t* q, const host_t* rf,
                                             const host_t* qN, const host_t* dx0,
                                             host_t* dx_out, host_t* du_out, host_t* dphi,
                                             int N, int B) {
  for (int b = 0; b < B; ++b)
    k4::forward<host_t>(Acl, K, bcl, kv, q, rf, qN, dx0, dx_out, du_out, dphi, N, B, b);
  return 0;
}

#endif
