// K1's stage math, shared by the kernels of sqp_planes.cu (K1s, the fused
// SQP trip's three launches) and, through k1s_passes.cuh, sqp_onepass.cu
// (K3s, whose Riccati pass is K1s-B):
//
// - the constants block and pack channel layouts (ops/sqp_planes.py);
// - the SRBD dynamics, its SO(3) chain, the stage's Euler Jacobian blocks
//   and skew generators, and the RK4 step, in srbd_planes.linearize_stage's
//   order (the float64 plane pass reads x, u and I^-1 through Staged);
// - dense small-matrix algebra in the plain version's operation order
//   (ops/smallmat.py): the Cholesky factorization and its solve.
//
// Contract: the plain PyTorch version srbd_nmpc_tpu_torch/ops/sqp_planes.py::
// sqp_qp_solve_onepass_planes_ref. Full-precision math only (sinf/cosf/
// sqrtf/logf/rsqrtf; never fast-math): the SO(3) chain runs down to the f32
// angle clamp 1e-4. Built with -fmad=false (utils/build.py), and the sums
// keep the plain version's order, so the kernels round like the plain
// version: the 12x12 stage solve is ill-conditioned enough (Reff ~ 1e-4
// against dt^2 B'PB) that f32 rounding differences alone move du by ~1e-4
// relative.
//
// Every function is __host__ __device__ and a template on the scalar type,
// so the kernels' bodies also compile as host C++ (without __CUDACC__): in
// double precision against the plain version, in single precision
// (-DSRBD_HOST_F32) for their rounding, and on the counting scalar
// (-DSRBD_OPCOUNT, utils/opcount.py).

#pragma once

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

// the state rows 3:6 and 9:12, where the control Jacobian is nonzero
HD constexpr int sel(int a) { return a < 3 ? 3 + a : 6 + a; }

// K1's three stage bodies: the structured stage in its K/kv form (the
// default), the rank-6 stage (rank6=True) and the structured stage parking
// its factor (factor=True)
enum Body { kGains = 0, kRank6 = 1, kFactor = 2 };

}  // namespace k1
