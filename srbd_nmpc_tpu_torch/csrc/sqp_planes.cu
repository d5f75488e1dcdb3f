// K1 · fused SQP trip at a candidate point, one thread per scenario.
//
// Replaces the TPU kernel srbd_nmpc_tpu/ops/sqp_planes.py::_onepass_planes_kernel
// (its plane phase _planes_phase and its three backward stage bodies). One
// instantiation per body; the C entry srbd_sqp_planes_launch takes the body
// as its first argument:
//
//   Body::kGains   the stage sqp_pallas._riccati_stage_structured in its K/kv
//                  form (the default);
//   Body::kRank6   _riccati_stage_rank6, selected by rank6=True
//                  (sqp_planes.py:362-367);
//   Body::kFactor  the structured stage parking its factor, selected by
//                  factor=True (sqp_planes.py:373-389, the epilogue :408-416).
//
// Contract: the plain PyTorch version srbd_nmpc_tpu_torch/ops/sqp_planes.py::
// sqp_qp_solve_onepass_planes_ref with the same rank6 / factor flags.
//
// What bounds it on the H100: each scenario is a long sequential recursion
// (N stages of linearization, then N dependent Riccati stages, then an N-step
// rollout) over about 20 KB of per-scenario state. It is latency- and
// register-bound per thread, not bandwidth- or FLOP-bound: the 12x12 stage
// alone keeps P (144), the Cholesky factor (78) and the 13-column forward
// substitution (156) live, past the 255-register cap. The rank-6 body trades
// them for four 6x6 factorizations and 6x13 solves (P, the 6x12 row block
// Y of P A and the 6x13 right-hand side live at once); the factor body drops
// the 13-column back substitution from each stage and adds a 12-step one per
// rollout stage, a serial chain inside the serial rollout.
//
// What this simple design does about it: one thread walks one scenario through
// three passes; nothing crosses lanes, so a compacted launch gives bitwise the
// same per-lane result as a full-width one. Pass 1 linearizes every stage,
// accumulates the merit and parks an 87-channel pack per stage in global
// scratch [N, 87, B]; pass 2 runs the backward Riccati and parks K [N,12,12,B],
// kv [N,12,B] (the factor body: Yh [N,12,12,B], yv [N,12,B], the lower
// triangle of L [N,78,B] and dinv [N,12,B]); pass 3 rolls forward and forms
// dphi. All global arrays are indexed (row * B + lane), so consecutive
// threads touch consecutive addresses. Small-matrix loops have compile-time
// bounds so arrays stay addressable by constants; whatever does not fit in
// registers spills to local memory, which is accepted here. Structural zeros
// of the SRBD Jacobians are never multiplied: the nonzero terms are written
// out (in the rank-6 stage, the products with the W' blocks, wt_mul, in the
// dense product's order, so that it still rounds as the plain version does;
// its Cholesky solves of those blocks run dense).
//
// Full-precision math only (sinf/cosf/sqrtf/logf/rsqrtf; never fast-math):
// the SO(3) chain runs down to the f32 angle clamp 1e-4. Built with
// -fmad=false (utils/build.py), and the sums keep the plain version's order,
// so the kernel rounds like the plain version: the 12x12 stage solve is
// ill-conditioned enough (Reff ~ 1e-4 against dt^2 B'PB) that f32 rounding
// differences alone move du by ~1e-4 relative.
//
// The per-scenario body is a template on the scalar type and also compiles as
// host C++ (without __CUDACC__) so its arithmetic can be checked on a CPU
// against the plain PyTorch version: in double precision, and in single
// precision (-DSRBD_HOST_F32) for the rounding of its plane phase.

#include "srbd_dev.cuh"

namespace k1 {

using namespace srbd_dev;

// constants block (offsets match ops/sqp_planes.py::_K_*)
constexpr int K_MASS = 0, K_DT = 1, K_IINV = 2, K_FOOT = 11;
constexpr int K_AC1 = 17, K_AC2 = 89, K_BC = 161;
constexpr int K_R = 185, K_Q = 329, K_QF = 473, K_LEN = 617;

// pack channels (as ops/sqp_planes.py::_D1 ...)
constexpr int P_D1 = 0, P_D2 = 9, P_SF = 18, P_SR = 21, P_SL = 24;
constexpr int P_B = 27, P_Q = 39, P_RF = 51, P_DDB = 63, P_C = 87;

// A lane's values kept in a staging area (row i at p[i * stride]) and read
// anew at each use: volatile, so that the compiler keeps none of them in
// registers between uses. The RK4 step takes x, u and I^-1 as arrays or as
// Staged (the float64 plane pass, k1s::plane_dyn).
template <typename T> struct Staged {
#ifdef SRBD_OPCOUNT
  const T* p;  // the operation counter's scalar is a class: read as it is
#else
  const volatile T* p;
#endif
  int stride;
  HD T operator[](int i) const { return p[i * stride]; }
  HD Staged operator+(int o) const { return {p + o * stride, stride}; }
};

// I^-1 as the dynamics take it: the matrix itself, or read anew from a
// staged constants block (I^-1's 9 entries row-major)
template <typename T> HD const M3<T>& iinv_at(const M3<T>& Iinv) { return Iinv; }
template <typename T> HD M3<T> iinv_at(const Staged<T>& s) {
  M3<T> I;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) I.m[i][j] = s[3 * i + j];
  return I;
}

// dx/dt of the SRBD (srbd_planes._deriv)
template <typename T, typename IV = M3<T>, typename UV = const T*>
HD void dynamics(const T* kc, const IV& Iinv, const T* x, UV u, T* out) {
  M3<T> R, Jlt;
  chain_lite(x, R, Jlt);
  const M3<T> A = rirt(R, iinv_at(Iinv));
  T w[3];
  mv3(A, x + 3, w);
  mv3(Jlt, w, out);
  const T* pf0 = kc + K_FOOT;
  const T* pf1 = kc + K_FOOT + 3;
  T d0[3], d1[3], c0[3], c1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d0[i] = pf0[i] - x[6 + i];
    d1[i] = pf1[i] - x[6 + i];
  }
  cross3(d0, u, c0);
  cross3(d1, u + 6, c1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 + i] = (u[3 + i] + u[9 + i]) + (c0[i] + c1[i]);
    out[6 + i] = x[9 + i];
  }
  const T inv_m = T(1) / kc[K_MASS];
  out[9] = inv_m * (u[0] + u[6]);
  out[10] = inv_m * (u[1] + u[7]);
  out[11] = inv_m * (u[2] + u[8]) + T(-9.8);
}

// The pieces of srbd_planes.linearize_stage, in its order (linearize_stage
// below runs them one after another). stage_chain: the Euler Jacobian
// blocks D1, D2 (row-major) and Jw = Jl^-1 (R I^-1 R' l), the rotation rows
// of the RK4 step's k1; it reads x's r and l (x[0..5]) alone
template <typename T>
HD void stage_chain(const M3<T>& Iinv, const T* x, T* D1, T* D2, T* Jw) {
  const T* r = x;
  const T* l = x + 3;

  // ---- so3 chain: R, Jl, Jlt and the djl_inv derivative pieces ----------
  const T t = safe_theta(r);
  const T st = k_sin(t), ct = k_cos(t);
  const T t2 = t * t;
  const T t3 = t2 * t;
  const T inv_t = T(1) / t;
  const M3<T> WW = skew_sq(r);
  const T sinc = st * inv_t;
  const T c2 = (T(1) - ct) / t2;
  const T it2 = inv_t * inv_t;
  const T cJ = (T(1) - ct) * inv_t;
  const T half_t = T(0.5) * t;
  const T hc = half_t * (k_cos(half_t) / k_sin(half_t));
  const T ca = (t * st + T(2) * (ct - T(1))) / t3;
  const T cb = -(T(2) * t - T(3) * st + t * ct) / t3;
  const T c1 = (t - st) / t3;

  M3<T> R, Jl, Jlt, base;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T vv = it2 * WW.m[i][j];
      if (i == j) {
        R.m[i][i] = T(1) + c2 * WW.m[i][i];
        Jl.m[i][i] = sinc + (T(1) - sinc) * (vv + T(1));
        Jlt.m[i][i] = hc + (T(1) - hc) * (vv + T(1));
        base.m[i][i] = cb * vv;
      } else {
        const T w = skew_at(r, i, j);
        const T v = inv_t * w;
        R.m[i][j] = sinc * w + c2 * WW.m[i][j];
        Jl.m[i][j] = (T(1) - sinc) * vv + cJ * v;
        Jlt.m[i][j] = (T(1) - hc) * vv + (-half_t) * v;
        base.m[i][j] = ca * v + cb * vv;
      }
    }

  const M3<T> A = rirt(R, Iinv);
  T w[3];
  mv3(A, l, w);
  mv3(Jlt, w, Jw);

  // djlt_a w = -(Jlt (djl_a (Jlt w))), with
  // djl_a = c1 (E_a W + W E_a) + c2 E_a + r_a base, E_a = skew(e_a):
  // (E_a W + W E_a) = r e_a' + e_a r' - 2 r_a I
  T djw[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    M3<T> dj;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T rb = r[a] * base.m[i][j];
        if (i == j) {
          dj.m[i][j] = (i == a) ? rb : c1 * (-r[a] - r[a]) + rb;
        } else if (i == a) {
          dj.m[i][j] = c1 * r[j] + rb;
        } else if (j == a) {
          dj.m[i][j] = c1 * r[i] + rb;
        } else {
          // E_a = skew(e_a): E_a[a+1][a+2] = -1, E_a[a+2][a+1] = +1
          const bool neg = ((a + 1) % 3 == i);
          dj.m[i][j] = (neg ? -c2 : c2) + rb;
        }
      }
    T y[3], z[3];
    mv3(dj, Jw, y);
    mv3(Jlt, y, z);
#pragma unroll
    for (int i = 0; i < 3; ++i) djw[a][i] = -z[i];
  }

  // core = Jlt ((A skew(l) - skew(w)) Jl); row i of A skew(l) is a_i x l
  M3<T> X;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T c[3];
    cross3(A.m[i], l, c);
#pragma unroll
    for (int j = 0; j < 3; ++j) X.m[i][j] = (i == j) ? c[j] : c[j] - skew_at(w, i, j);
  }
  const M3<T> core = mul3(Jlt, mul3(X, Jl));
  const M3<T> D2m = mul3(Jlt, A);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      D1[3 * i + a] = djw[a][i] + core.m[i][a];
      D2[3 * i + a] = D2m.m[i][a];
    }
}

// the skew generators sF, sr, sl of the stage
template <typename T>
HD void stage_skews(const T* kc, const T* x, const T* u, T* sF, T* sr, T* sl) {
  const T* pf0 = kc + K_FOOT;
  const T* pf1 = kc + K_FOOT + 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sF[i] = u[i] + u[6 + i];
    sr[i] = pf0[i] - x[6 + i];
    sl[i] = pf1[i] - x[6 + i];
  }
}

// the RK4 step x_next over dt, k1 from the chain's Jw and the stage's sr,
// sl (x, u and I^-1 as arrays or Staged). kRunning keeps the sum of the k's
// as a running sum, s = k1 + 2 k2, then s + 2 k3, then s + k4: the same
// operations in the same order, so the same rounding, with each k dropped
// as it is added
template <typename T, bool kRunning = false, typename IV = M3<T>, typename XV = const T*,
          typename UV = const T*>
HD void rk4_step(const T* kc, T dt, const IV& Iinv, XV x, UV u, const T* Jw, const T* sr,
                 const T* sl, T* x_next) {
  T k1[12], k2[12], k3[12], k4[12], xs[12];
  T c0[3], cc1[3];
  cross3(sr, u, c0);
  cross3(sl, u + 6, cc1);
  const T inv_m = T(1) / kc[K_MASS];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k1[i] = Jw[i];
    k1[3 + i] = (u[3 + i] + u[9 + i]) + (c0[i] + cc1[i]);
    k1[6 + i] = x[9 + i];
  }
  k1[9] = inv_m * (u[0] + u[6]);
  k1[10] = inv_m * (u[1] + u[7]);
  k1[11] = inv_m * (u[2] + u[8]) + T(-9.8);

  const T hdt = T(0.5) * dt;
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + hdt * k1[i];
  dynamics(kc, Iinv, xs, u, k2);
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + hdt * k2[i];
  if constexpr (kRunning) {
#pragma unroll
    for (int i = 0; i < 12; ++i) k1[i] = k1[i] + T(2) * k2[i];
  }
  dynamics(kc, Iinv, xs, u, k3);
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + dt * k3[i];
  if constexpr (kRunning) {
#pragma unroll
    for (int i = 0; i < 12; ++i) k1[i] = k1[i] + T(2) * k3[i];
  }
  dynamics(kc, Iinv, xs, u, k4);
  const T dt6 = dt / T(6);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    x_next[i] = kRunning ? x[i] + dt6 * (k1[i] + k4[i])
                         : x[i] + dt6 * (((k1[i] + T(2) * k2[i]) + T(2) * k3[i]) + k4[i]);
}

// Euler Jacobian blocks D1, D2 (row-major), skew generators sF, sr, sl and
// the RK4 step x_next (srbd_planes.linearize_stage)
template <typename T>
HD void linearize_stage(const T* kc, const M3<T>& Iinv, const T* x, const T* u,
                        T* D1, T* D2, T* sF, T* sr, T* sl, T* x_next) {
  const T dt = kc[K_DT];
  T Jw[3];
  stage_chain(Iinv, x, D1, D2, Jw);
  stage_skews(kc, x, u, sF, sr, sl);
  rk4_step(kc, dt, Iinv, x, u, Jw, sr, sl, x_next);
}

// ---------------------------------------------------------------------------
// Dense small-matrix algebra in the plain version's operation order
// (ops/smallmat.py): every sum runs left to right over the inner index.
// ---------------------------------------------------------------------------

// C = A B
template <typename T, int n, int kk, int m>
HD void mm(const T (&A)[n][kk], const T (&B)[kk][m], T (&C)[n][m]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < m; ++j) {
      T acc = A[i][0] * B[0][j];
#pragma unroll
      for (int k = 1; k < kk; ++k) acc = acc + A[i][k] * B[k][j];
      C[i][j] = acc;
    }
}

// C = A' B
template <typename T, int kk, int n, int m>
HD void mtm(const T (&A)[kk][n], const T (&B)[kk][m], T (&C)[n][m]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < m; ++j) {
      T acc = A[0][i] * B[0][j];
#pragma unroll
      for (int k = 1; k < kk; ++k) acc = acc + A[k][i] * B[k][j];
      C[i][j] = acc;
    }
}

// y = A v
template <typename T, int n, int kk>
HD void mv(const T (&A)[n][kk], const T* v, T* y) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T acc = A[i][0] * v[0];
#pragma unroll
    for (int k = 1; k < kk; ++k) acc = acc + A[i][k] * v[k];
    y[i] = acc;
  }
}

// Right-looking Cholesky of the SPD matrix in the lower triangle of S, in
// place: S becomes L (zeros above the diagonal), dinv = rsqrt(pivot)
template <typename T, int n>
HD void cholesky(T (&S)[n][n], T (&dinv)[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const T di = k_rsqrt(S[j][j]);
    dinv[j] = di;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if (i < j) S[i][j] = T(0);
      else S[i][j] = S[i][j] * di;
    }
#pragma unroll
    for (int c = 0; c < n; ++c)
#pragma unroll
      for (int i = 0; i < n; ++i)
        if (c > j && i >= c) S[i][c] = S[i][c] - S[i][j] * S[c][j];
  }
}

// (L L') X = R for R [n][m], in place: L^-1 forward, then L'^-1 backward
template <typename T, int n, int m>
HD void chol_solve(const T (&L)[n][n], const T (&dinv)[n], T (&X)[n][m]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < m; ++c) X[i][c] = X[i][c] * dinv[i];
#pragma unroll
    for (int r = 0; r < n; ++r)
      if (r > i) {
#pragma unroll
        for (int c = 0; c < m; ++c) X[r][c] = X[r][c] - L[r][i] * X[i][c];
      }
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < m; ++c) X[i][c] = X[i][c] * dinv[i];
#pragma unroll
    for (int r = 0; r < n; ++r)
      if (r < i) {
#pragma unroll
        for (int c = 0; c < m; ++c) X[r][c] = X[r][c] - L[i][r] * X[i][c];
      }
  }
}

// (L L') x = r for a vector, in place
template <typename T, int n>
HD void chol_solve_vec(const T (&L)[n][n], const T (&dinv)[n], T (&x)[n]) {
  T X[n][1];
#pragma unroll
  for (int i = 0; i < n; ++i) X[i][0] = x[i];
  chol_solve(L, dinv, X);
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = X[i][0];
}

// the state rows 3:6 and 9:12, where the control Jacobian is nonzero
HD constexpr int sel(int a) { return a < 3 ? 3 + a : 6 + a; }

// C' E for a W' block C = [[S', I/m], [I, 0]], S = skew(s): row i < 3 of
// C' is (S[i][0..2], e_i'), row 3 + i is e_i' / m. Only the terms that are
// not structurally zero or one are formed, in the dense product's order
// (k ascending), so for finite E each sum rounds as mtm(C, E) does: a
// product with a zero entry adds a signed zero, one with a one is exact.
template <typename T, int m>
HD void wt_mul(const T* s, T m_inv, const T (&E)[6][m], T (&C)[6][m]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k0 = i == 0 ? 1 : 0, k1 = i == 2 ? 1 : 2;  // {0, 1, 2} \ {i}
#pragma unroll
    for (int j = 0; j < m; ++j) {
      T acc = skew_at(s, i, k0) * E[k0][j];
      acc = acc + skew_at(s, i, k1) * E[k1][j];
      C[i][j] = acc + E[3 + i][j];
      C[3 + i][j] = m_inv * E[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The rank-6 backward Riccati stage (sqp_planes.py::_riccati_stage_rank6,
// the port's plain version in ops/sqp_planes.py, op for op). B = dt S W with
// W = [[Sr, I, Sl, I], [I/m, 0, I/m, 0]] on the state rows sel(0..5); with
// R^ = Reff + reg I leg-block-diagonal (R1h, R2h), T = W R^-1 W' = Lt Lt',
// Ms = I + dt^2 Lt' Pss Lt = Lm Lm', G^-1 W' = R^-1 W' (I + dt^2 Pss T)^-1.
// Same inputs as riccati_stage_structured (R must be leg-block-diagonal:
// the host decides); updates (P, p) in place and writes the gains K, kv.
// ---------------------------------------------------------------------------
template <typename T>
HD void riccati_stage_rank6(const T (&D1)[3][3], const T (&D2)[3][3], const T* sF,
                            const T* sr, const T* sl, const T* bv, const T* q,
                            const T* rf, const T* ddb, const T* Ac1, const T* Ac2,
                            const T* Rw, const T* Qw, T dt, T m_inv, T reg,
                            T (&P)[12][12], T* p, T (&K)[12][12], T* kv) {
  const T dt2 = dt * dt;
  T Pbp[12];
  stage_pbp(P, bv, p, Pbp);
  T V[12][12];
  stage_jxt_p(P, D1, D2, sF, V);

  // Y = rows sel of P A = P + dt V'; ys = rows sel of Pb_p; Pss
  T Y[6][12], ys[6], Pss[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int j = 0; j < 12; ++j) Y[a][j] = P[sel(a)][j] + dt * V[j][sel(a)];
    ys[a] = Pbp[sel(a)];
#pragma unroll
    for (int c = 0; c < 6; ++c) Pss[a][c] = P[sel(a)][sel(c)];
  }

  // W' blocks C1 = [[Sr', I/m], [I, 0]], C2 = [[Sl', I/m], [I, 0]]
  T C1[6][6], C2[6][6];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      C1[k][c] = skew_at(sr, c, k);
      C2[k][c] = skew_at(sl, c, k);
      C1[k][3 + c] = C2[k][3 + c] = (k == c) ? m_inv : T(0);
      C1[3 + k][c] = C2[3 + k][c] = (k == c) ? T(1) : T(0);
      C1[3 + k][3 + c] = C2[3 + k][3 + c] = T(0);
    }

  // R1h, R2h: R's diagonal leg blocks + Ac' diag(ddb) Ac + reg I, factored
  T L1[6][6], L2[6][6], d1[6], d2[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j > i) continue;
      T c1 = Ac1[i] * (Ac1[j] * ddb[0]);
      T c2 = Ac2[i] * (Ac2[j] * ddb[12]);
#pragma unroll
      for (int g = 1; g < 12; ++g) {
        c1 = c1 + Ac1[6 * g + i] * (Ac1[6 * g + j] * ddb[g]);
        c2 = c2 + Ac2[6 * g + i] * (Ac2[6 * g + j] * ddb[12 + g]);
      }
      L1[i][j] = Rw[12 * i + j] + c1;
      L2[i][j] = Rw[12 * (6 + i) + 6 + j] + c2;
      if (i == j) {
        L1[i][j] = L1[i][j] + reg;
        L2[i][j] = L2[i][j] + reg;
      }
    }
  cholesky(L1, d1);
  cholesky(L2, d2);

  // E = R^-1 W' (two blocks), T = W R^-1 W' = C1' E1 + C2' E2
  T E1[6][6], E2[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      E1[i][j] = C1[i][j];
      E2[i][j] = C2[i][j];
    }
  chol_solve(L1, d1, E1);
  chol_solve(L2, d2, E2);
  T Tm[6][6], Lt[6][6], dt6[6];
  {
    T A[6][6];
    wt_mul(sr, m_inv, E1, Tm);
    wt_mul(sl, m_inv, E2, A);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        Tm[i][j] = Tm[i][j] + A[i][j];
        Lt[i][j] = Tm[i][j];
      }
  }
  cholesky(Lt, dt6);

  // Ms = I + dt^2 Lt' Pss Lt, factored
  T Lm[6][6], dm[6];
  {
    T PssLt[6][6], A[6][6];
    mm(Pss, Lt, PssLt);
    mtm(Lt, PssLt, A);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) Lm[i][j] = (i == j) ? dt2 * A[i][j] + T(1) : dt2 * A[i][j];
  }
  cholesky(Lm, dm);

  // r~ = R^-1 reff, w_r = W r~, zvec = dt ys - dt^2 Pss w_r
  T rt1[6], rt2[6], wr[6], zv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    rt1[i] = rf[i];
    rt2[i] = rf[6 + i];
  }
  chol_solve_vec(L1, d1, rt1);
  chol_solve_vec(L2, d2, rt2);
  {
    T r1[6][1], r2[6][1], a1[6][1], a2[6][1], a[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      r1[i][0] = rt1[i];
      r2[i][0] = rt2[i];
    }
    wt_mul(sr, m_inv, r1, a1);
    wt_mul(sl, m_inv, r2, a2);
#pragma unroll
    for (int i = 0; i < 6; ++i) wr[i] = a1[i][0] + a2[i][0];
    mv(Pss, wr, a);
#pragma unroll
    for (int i = 0; i < 6; ++i) zv[i] = dt * ys[i] - dt2 * a[i];
  }

  // X = M6^-1 [Y | zvec] = RHS - dt^2 Pss Lt w, w = Ms^-1 Lt' RHS
  T X[6][13];
  {
    T W[6][13], LW[6][13], PLW[6][13];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 12; ++j) X[i][j] = Y[i][j];
      X[i][12] = zv[i];
    }
    mtm(Lt, X, W);
    chol_solve(Lm, dm, W);
    mm(Lt, W, LW);
    mm(Pss, LW, PLW);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int c = 0; c < 13; ++c) X[i][c] = X[i][c] - dt2 * PLW[i][c];
  }

  // K = -dt [E1 Yh; E2 Yh], kv = -[rt1 + E1 zh; rt2 + E2 zh]
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T a = E1[i][0] * X[0][j], b = E2[i][0] * X[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        a = a + E1[i][k] * X[k][j];
        b = b + E2[i][k] * X[k][j];
      }
      K[i][j] = -dt * a;
      K[6 + i][j] = -dt * b;
    }
    T a = E1[i][0] * X[0][12], b = E2[i][0] * X[0][12];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      a = a + E1[i][k] * X[k][12];
      b = b + E2[i][k] * X[k][12];
    }
    kv[i] = -(rt1[i] + a);
    kv[6 + i] = -(rt2[i] + b);
  }

  // H'K = dt Y'(W K), W K = -dt T Yh; H'kv = dt Y'(W kv), W kv = -(w_r + T zh)
  T WK[6][12], Wkv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T acc = Tm[i][0] * X[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + Tm[i][k] * X[k][j];
      WK[i][j] = -dt * acc;
    }
    T acc = Tm[i][0] * X[0][12];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + Tm[i][k] * X[k][12];
    Wkv[i] = -(wr[i] + acc);
  }

  // P_new = Qw + P + dt (M + V) + dt^2 Jx' M + H'K, symmetrized, M = V';
  // in place: entries (i, j) and (j, i) read only P[i][j] and P[j][i]
#pragma unroll
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      if (j < i) continue;
      T hij = Y[0][i] * WK[0][j], hji = Y[0][j] * WK[0][i];
#pragma unroll
      for (int r = 1; r < 6; ++r) {
        hij = hij + Y[r][i] * WK[r][j];
        hji = hji + Y[r][j] * WK[r][i];
      }
      const T mvv = dt * (V[j][i] + V[i][j]);
      const T xij = (((Qw[12 * i + j] + P[i][j]) + mvv)
                     + dt2 * jxt_m(V, D1, D2, sF, i, j)) + dt * hij;
      const T xji = (((Qw[12 * j + i] + P[j][i]) + mvv)
                     + dt2 * jxt_m(V, D1, D2, sF, j, i)) + dt * hji;
      const T s = T(0.5) * (xij + xji);
      P[i][j] = s;
      P[j][i] = s;
    }
  }
  // p_new = q + Pb_p + dt Jx' Pb_p + H'kv
  T jv[12];
  stage_jxt_v(D1, D2, sF, Pbp, jv);
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Y[0][i] * Wkv[0];
#pragma unroll
    for (int r = 1; r < 6; ++r) acc = acc + Y[r][i] * Wkv[r];
    p[i] = ((q[i] + Pbp[i]) + dt * jv[i]) + dt * acc;
  }
}

// ---------------------------------------------------------------------------
// one scenario, three passes
// ---------------------------------------------------------------------------
enum Body { kGains = 0, kRank6 = 1, kFactor = 2 };

// park0/park1: K [N,12,12,B] and kv [N,12,B]; the factor body parks Yh and
// yv there, and the lower triangle of L [N,78,B] and dinv [N,12,B] in
// park2/park3 (unused by the other bodies)
template <typename T, int kBody>
HD void scenario(const T* kc, const T* xa, const T* us, const T* xr, const T* dxc,
                 const T* duc, const T* alpha, const T* dx0, T* dx_out, T* du_out,
                 T* dphi_out, T* theta_out, T* phi_out, T* maxdef_out,
                 T* mincon_out, T* pack, T* park0, T* park1, T* park2, T* park3,
                 int N, int B, int b, T mu_b, T theta_b, T reg) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  const T dt = kc[K_DT];
  const T m_inv = T(1) / kc[K_MASS];
  const T a = alpha[b];
  M3<T> Iinv;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Iinv.m[i][j] = kc[K_IINV + 3 * i + j];
  const T* Ac1 = kc + K_AC1;  // [12, 6]
  const T* Ac2 = kc + K_AC2;
  const T* bc = kc + K_BC;
  const T* Rw = kc + K_R;
  const T* Qw = kc + K_Q;
  const T* Qf = kc + K_QF;
  const T log_th = k_log(theta_b);
  const T ddb_quad = mu_b / (theta_b * theta_b);

  // ======================= pass 1: planes phase ===========================
  T theta = 0, s_bar = 0, s_uRu = 0, s_eq = 0;
  T maxdef = 0, mincon = 0;
  for (int k = 0; k < N; ++k) {
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
#define PK(c) pk[(size_t)(c) * B + b]
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
    for (int i = 0; i < 12; ++i) {
      const T bi = xnext[i] - xn[i];
      PK(P_B + i) = bi;
      theta += bi * bi;
      const T ab = bi < 0 ? -bi : bi;
      maxdef = (k == 0 && i == 0) ? ab : (ab > maxdef || ab != ab ? ab : maxdef);
    }

    // constraints + relaxed barrier (24 rows)
    T db[24];
#pragma unroll
    for (int g = 0; g < 24; ++g) {
      const T* arow = (g < 12) ? Ac1 + 6 * g : Ac2 + 6 * (g - 12);
      const T* ug = (g < 12) ? u : u + 6;
      T con = arow[0] * ug[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) con = con + arow[j] * ug[j];
      con = con + bc[g];
      mincon = (k == 0 && g == 0) ? con : (con < mincon || con != con ? con : mincon);
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
      s_bar += bb;
      db[g] = d;
      PK(P_DDB + g) = dd;
    }

#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T qi = Qw[12 * i] * e[0];
      T ri = Rw[12 * i] * u[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) {
        qi = qi + Qw[12 * i + j] * e[j];
        ri = ri + Rw[12 * i + j] * u[j];
      }
      s_eq += e[i] * qi;
      s_uRu += u[i] * ri;
      const T* Ab = (i < 6) ? Ac1 + i : Ac2 + (i - 6);
      const T* dbl = (i < 6) ? db : db + 12;
      T acc = Ab[0] * dbl[0];
#pragma unroll
      for (int g = 1; g < 12; ++g) acc = acc + Ab[6 * g] * dbl[g];
      PK(P_Q + i) = qi;
      PK(P_RF + i) = ri + acc;
    }
  }

  // terminal stage + Riccati seed
  T P[12][12], p[12], qN[12], eN[12];
#pragma unroll
  for (int i = 0; i < 12; ++i)
    eN[i] = AT(xa, N * 12 + i) + a * AT(dxc, N * 12 + i) - AT(xr, N * 12 + i);
  T phiN = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    T acc = Qf[12 * i] * eN[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc = acc + Qf[12 * i + j] * eN[j];
    qN[i] = acc;
    p[i] = acc;
    phiN += eN[i] * acc;
#pragma unroll
    for (int j = 0; j < 12; ++j) P[i][j] = Qf[12 * i + j];
  }
  AT(theta_out, 0) = T(0.5) * theta;
  AT(phi_out, 0) = s_bar + T(0.5) * s_uRu + T(0.5) * s_eq + T(0.5) * phiN;
  AT(maxdef_out, 0) = maxdef;
  AT(mincon_out, 0) = mincon;

  // ======================= pass 2: backward Riccati =======================
  for (int k = N - 1; k >= 0; --k) {
    const T* pk = pack + (size_t)k * P_C * B;
    T D1[3][3], D2[3][3], sF[3], sr[3], sl[3], bv[12], q[12], rf[12];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        D1[i][j] = PK(P_D1 + 3 * i + j);
        D2[i][j] = PK(P_D2 + 3 * i + j);
      }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sF[i] = PK(P_SF + i);
      sr[i] = PK(P_SR + i);
      sl[i] = PK(P_SL + i);
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      bv[i] = PK(P_B + i);
      q[i] = PK(P_Q + i);
      rf[i] = PK(P_RF + i);
    }
    T ddb[24];
#pragma unroll
    for (int g = 0; g < 24; ++g) ddb[g] = PK(P_DDB + g);

    if constexpr (kBody == kGains) {
      // structured Riccati stage (srbd_dev.cuh); [K | kv] = -Y, parked in
      // global scratch
      T Y[12][13];
      riccati_stage_structured(D1, D2, sF, sr, sl, bv, q, rf, ddb, Ac1, Ac2, Rw, Qw, dt,
                               m_inv, reg, P, p, Y);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
#pragma unroll
        for (int j = 0; j < 12; ++j) AT(park0, (k * 12 + i) * 12 + j) = -Y[i][j];
        AT(park1, k * 12 + i) = -Y[i][12];
      }
    } else if constexpr (kBody == kRank6) {
      T K[12][12], kv[12];
      riccati_stage_rank6(D1, D2, sF, sr, sl, bv, q, rf, ddb, Ac1, Ac2, Rw, Qw, dt, m_inv,
                          reg, P, p, K, kv);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
#pragma unroll
        for (int j = 0; j < 12; ++j) AT(park0, (k * 12 + i) * 12 + j) = K[i][j];
        AT(park1, k * 12 + i) = kv[i];
      }
    } else {
      // the stage without its back substitution: park [Yh | yv], L, dinv
      T Y[12][13], Lt[78], dinv[12];
      riccati_stage_structured<T, false>(D1, D2, sF, sr, sl, bv, q, rf, ddb, Ac1, Ac2,
                                         Rw, Qw, dt, m_inv, reg, P, p, Y, Lt, dinv);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
#pragma unroll
        for (int j = 0; j < 12; ++j) AT(park0, (k * 12 + i) * 12 + j) = Y[i][j];
        AT(park1, k * 12 + i) = Y[i][12];
        AT(park3, k * 12 + i) = dinv[i];
      }
#pragma unroll
      for (int i = 0; i < 78; ++i) AT(park2, k * 78 + i) = Lt[i];
    }
  }

  // ======================= pass 3: rollout + dphi =========================
  T dx[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) dx[i] = AT(dx0, i);
  T tot = 0;
  for (int k = 0; k < N; ++k) {
    const T* pk = pack + (size_t)k * P_C * B;
    // du = K dx + kv; the factor body: t = Yh dx + yv, du = -L'^-1 t
    T du[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = AT(park0, (k * 12 + i) * 12) * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc = acc + AT(park0, (k * 12 + i) * 12 + j) * dx[j];
      du[i] = acc + AT(park1, k * 12 + i);
    }
    if constexpr (kBody == kFactor) {
#pragma unroll
      for (int i = 11; i >= 0; --i) {
        const T xi = du[i] * AT(park3, k * 12 + i);
        du[i] = xi;
#pragma unroll
        for (int r = 0; r < 12; ++r)
          if (r < i) du[r] = du[r] - AT(park2, k * 78 + i * (i + 1) / 2 + r) * xi;
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
      AT(du_out, k * 12 + i) = du[i];
      dx[i] = (dx[i] + PK(P_B + i)) + dt * jd[i];
      AT(dx_out, k * 12 + i) = dx[i];
    }
  }
  T last = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) last += dx[i] * qN[i];
  AT(dphi_out, 0) = tot + last;
#undef PK
#undef AT
}

}  // namespace k1

// K1_NO_ENTRIES: the bodies alone, for a source that includes this one
// (sqp_planes_split.cu)
#ifndef K1_NO_ENTRIES
#ifdef __CUDACC__

template <int kBody>
__global__ void sqp_planes_kernel(const float* __restrict__ consts, const float* xa,
                                  const float* us, const float* xr, const float* dxc,
                                  const float* duc, const float* alpha, const float* dx0,
                                  float* dx_out, float* du_out, float* dphi, float* theta,
                                  float* phi, float* maxdef, float* mincon, float* pack,
                                  float* park0, float* park1, float* park2, float* park3,
                                  int N, int B, float mu_b, float theta_b, float reg) {
  __shared__ float kc[k1::K_LEN];
  for (int i = threadIdx.x; i < k1::K_LEN; i += blockDim.x) kc[i] = consts[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  k1::scenario<float, kBody>(kc, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi,
                             theta, phi, maxdef, mincon, pack, park0, park1, park2, park3,
                             N, B, b, mu_b, theta_b, reg);
}

// body: 0 gains, 1 rank-6 (R must be leg-block-diagonal), 2 factor (k1::Body).
// park0/park1: K [N,12,12,B] and kv [N,12,B], or for the factor body Yh
// [N,12,12,B] and yv [N,12,B], with the lower triangle of L [N,78,B] in
// park2 and dinv [N,12,B] in park3 (null for the other bodies)
extern "C" int srbd_sqp_planes_launch(int body, const float* consts, const float* xa,
                                      const float* us, const float* xr, const float* dxc,
                                      const float* duc, const float* alpha,
                                      const float* dx0, float* dx_out, float* du_out,
                                      float* dphi, float* theta, float* phi, float* maxdef,
                                      float* mincon, float* pack, float* park0,
                                      float* park1, float* park2, float* park3, int N,
                                      int B, float mu_b, float theta_b, float reg,
                                      int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
#define K1_ARGS                                                                       \
  consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi, theta, phi, maxdef, \
      mincon, pack, park0, park1, park2, park3, N, B, mu_b, theta_b, reg
  switch (body) {
    case k1::kGains: sqp_planes_kernel<k1::kGains><<<blocks, threads, 0, st>>>(K1_ARGS); break;
    case k1::kRank6: sqp_planes_kernel<k1::kRank6><<<blocks, threads, 0, st>>>(K1_ARGS); break;
    case k1::kFactor: sqp_planes_kernel<k1::kFactor><<<blocks, threads, 0, st>>>(K1_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_ARGS
  return (int)cudaGetLastError();
}

#else  // host build: the same per-scenario bodies over every lane

// host_t: double; float under -DSRBD_HOST_F32 (the kernel's own precision),
// the op counter under -DSRBD_OPCOUNT
using srbd_dev::host_t;

// the arguments of srbd_sqp_planes_launch, on the host
extern "C" int srbd_sqp_planes_host(int body, const host_t* consts, const host_t* xa,
                                    const host_t* us, const host_t* xr, const host_t* dxc,
                                    const host_t* duc, const host_t* alpha,
                                    const host_t* dx0, host_t* dx_out, host_t* du_out,
                                    host_t* dphi, host_t* theta, host_t* phi,
                                    host_t* maxdef, host_t* mincon, host_t* pack,
                                    host_t* park0, host_t* park1, host_t* park2,
                                    host_t* park3, int N, int B, double mu_b,
                                    double theta_b, double reg) {
  if (body < k1::kGains || body > k1::kFactor) return 1;
  const host_t mu(mu_b), th(theta_b), rg(reg);
  for (int b = 0; b < B; ++b) {
#define K1_ARGS                                                                       \
  consts, xa, us, xr, dxc, duc, alpha, dx0, dx_out, du_out, dphi, theta, phi, maxdef, \
      mincon, pack, park0, park1, park2, park3, N, B, b, mu, th, rg
    if (body == k1::kGains) k1::scenario<host_t, k1::kGains>(K1_ARGS);
    else if (body == k1::kRank6) k1::scenario<host_t, k1::kRank6>(K1_ARGS);
    else k1::scenario<host_t, k1::kFactor>(K1_ARGS);
#undef K1_ARGS
  }
  return 0;
}

#endif
#endif  // K1_NO_ENTRIES
