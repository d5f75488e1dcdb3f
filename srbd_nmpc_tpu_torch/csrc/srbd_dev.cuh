// Device helpers shared by the port's CUDA kernels: scalar math, 3x3 algebra,
// the SO(3) small-angle clamp, the relaxed log barrier, the SRBD model in
// the evaluation order of srbd_nmpc_tpu_torch/models/srbd_soa.py (its SO(3)
// chain, Jacobian blocks, dense Jacobian entries and four-call RK4), and
// pieces of the fused SQP trips (ops/sqp_stage.py): the Jacobian products of
// the structured Riccati stage (K1s-B, its team form), the backward-order
// merit (K3, K4a) and the closed-loop rollout (K4b).
//
// Every function is __host__ __device__ and a template on the scalar type, so
// each kernel's per-thread body also compiles as host C++ (without __CUDACC__)
// and is checked in double precision against its plain PyTorch version on a
// CPU. Full-precision math only (never fast-math); the kernels are built with
// -fmad=false, so each operation rounds once, as in the plain versions.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace srbd_dev {

HD float k_sqrt(float x) { return sqrtf(x); }
HD double k_sqrt(double x) { return sqrt(x); }
HD float k_sin(float x) { return sinf(x); }
HD double k_sin(double x) { return sin(x); }
HD float k_cos(float x) { return cosf(x); }
HD double k_cos(double x) { return cos(x); }
HD float k_log(float x) { return logf(x); }
HD double k_log(double x) { return log(x); }
// on the card the library's rsqrt, as PyTorch's rsqrt on CUDA tensors (in
// float and double); on the host the division, as its rsqrt on the CPU
#ifdef __CUDACC__
HD float k_rsqrt(float x) { return rsqrtf(x); }
HD double k_rsqrt(double x) { return rsqrt(x); }
#else
HD float k_rsqrt(float x) { return 1.0f / sqrtf(x); }
HD double k_rsqrt(double x) { return 1.0 / sqrt(x); }
#endif

template <typename T> HD T theta_min_sq();
template <> HD float theta_min_sq<float>() { return 1e-8f; }     // (1e-4)^2
template <> HD double theta_min_sq<double>() { return 1e-20; }   // (1e-10)^2

#ifndef __CUDACC__
#ifdef SRBD_OPCOUNT
// Host build with -DSRBD_OPCOUNT: a double that counts the floating-point
// operations done on it, so the kernels' own arithmetic (the branch each
// lane takes included) is counted by running their per-thread bodies.
// Counted, one each: + - * / and sqrt, rsqrt, sin, cos, log. Not counted:
// negation (an operand modifier on the card), comparisons and selects.
// Layout-compatible with double: the host entries take the same buffers.
struct OpCount {
  double v;
  static inline long long n = 0;
  OpCount() = default;
  OpCount(double x) : v(x) {}
  friend OpCount operator+(OpCount a, OpCount b) { ++n; return a.v + b.v; }
  friend OpCount operator-(OpCount a, OpCount b) { ++n; return a.v - b.v; }
  friend OpCount operator*(OpCount a, OpCount b) { ++n; return a.v * b.v; }
  friend OpCount operator/(OpCount a, OpCount b) { ++n; return a.v / b.v; }
  friend OpCount operator-(OpCount a) { return -a.v; }
  OpCount& operator+=(OpCount b) { return *this = *this + b; }
  friend bool operator<(OpCount a, OpCount b) { return a.v < b.v; }
  friend bool operator>(OpCount a, OpCount b) { return a.v > b.v; }
  friend bool operator!=(OpCount a, OpCount b) { return a.v != b.v; }
  friend OpCount k_sqrt(OpCount a) { ++n; return sqrt(a.v); }
  friend OpCount k_rsqrt(OpCount a) { ++n; return 1.0 / sqrt(a.v); }
  friend OpCount k_sin(OpCount a) { ++n; return sin(a.v); }
  friend OpCount k_cos(OpCount a) { ++n; return cos(a.v); }
  friend OpCount k_log(OpCount a) { ++n; return log(a.v); }
};
static_assert(sizeof(OpCount) == sizeof(double), "OpCount must alias double");
template <> HD OpCount theta_min_sq<OpCount>() { return 1e-8; }  // the f32 clamp

// operations counted since the last call
extern "C" long long srbd_opcount_take() {
  const long long n = OpCount::n;
  OpCount::n = 0;
  return n;
}
using host_t = OpCount;
#elif defined(SRBD_HOST_F32)
using host_t = float;  // a host build in the kernels' own precision
#else
using host_t = double;
#endif
#endif

template <typename T> struct M3 { T m[3][3]; };

template <typename T>
HD M3<T> mul3(const M3<T>& A, const M3<T>& B) {
  M3<T> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.m[i][j] = A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j] + A.m[i][2] * B.m[2][j];
  return C;
}

// A @ B'
template <typename T>
HD M3<T> mul3t(const M3<T>& A, const M3<T>& B) {
  M3<T> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.m[i][j] = A.m[i][0] * B.m[j][0] + A.m[i][1] * B.m[j][1] + A.m[i][2] * B.m[j][2];
  return C;
}

template <typename T>
HD void mv3(const M3<T>& A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = A.m[i][0] * v[0] + A.m[i][1] * v[1] + A.m[i][2] * v[2];
}

// a x b; b a pointer, or any type read by b[i] (k1::Staged)
template <typename T, typename BV>
HD void cross3(const T* a, BV b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// skew(r) entry (i, j); zero on the diagonal
template <typename T>
HD T skew_at(const T* r, int i, int j) {
  if (i == 0 && j == 1) return -r[2];
  if (i == 0 && j == 2) return r[1];
  if (i == 1 && j == 0) return r[2];
  if (i == 1 && j == 2) return -r[0];
  if (i == 2 && j == 0) return -r[1];
  if (i == 2 && j == 1) return r[0];
  return T(0);
}

// skew(r)^2 = r r' - |r|^2 I, nonzero terms only
template <typename T>
HD M3<T> skew_sq(const T* r) {
  M3<T> W;
  W.m[0][0] = -(r[2] * r[2]) - r[1] * r[1];
  W.m[1][1] = -(r[2] * r[2]) - r[0] * r[0];
  W.m[2][2] = -(r[1] * r[1]) - r[0] * r[0];
  W.m[0][1] = r[1] * r[0];
  W.m[1][0] = r[0] * r[1];
  W.m[0][2] = r[2] * r[0];
  W.m[2][0] = r[0] * r[2];
  W.m[1][2] = r[2] * r[1];
  W.m[2][1] = r[1] * r[2];
  return W;
}

template <typename T>
HD T safe_theta(const T* r) {
  T sq = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
  const T h2 = theta_min_sq<T>();
  sq = (sq < h2) ? h2 : sq;  // a NaN angle stays NaN
  return k_sqrt(sq);
}

// R = expm(skew r) and Jlt = Jl(r)^-1 (srbd_planes._chain_lite forms)
template <typename T>
HD void chain_lite(const T* r, M3<T>& R, M3<T>& Jlt) {
  const T t = safe_theta(r);
  const T st = k_sin(t), ct = k_cos(t);
  const T inv_t = T(1) / t;
  const M3<T> WW = skew_sq(r);
  const T sinc = st * inv_t;
  const T cR = (T(1) - ct) * inv_t * inv_t;
  const T it2 = inv_t * inv_t;
  const T half_t = T(0.5) * t;
  const T hc = half_t * (k_cos(half_t) / k_sin(half_t));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T vv = it2 * WW.m[i][j];
      if (i == j) {
        R.m[i][i] = T(1) + cR * WW.m[i][i];
        Jlt.m[i][i] = hc + (T(1) - hc) * (vv + T(1));
      } else {
        const T w = skew_at(r, i, j);
        R.m[i][j] = sinc * w + cR * WW.m[i][j];
        Jlt.m[i][j] = (T(1) - hc) * vv + (-half_t) * (inv_t * w);
      }
    }
}

// R I^-1 R'
template <typename T>
HD M3<T> rirt(const M3<T>& R, const M3<T>& Iinv) {
  return mul3t(mul3(R, Iinv), R);
}

// relaxed log barrier of one constraint value (ops/barrier.py): value,
// first and second derivative; a NaN value takes the quadratic branch
template <typename T>
HD void barrier(T con, T mu_b, T theta_b, T log_th, T& bb, T& d, T& dd) {
  if (con > theta_b) {
    bb = -mu_b * k_log(con);
    d = -mu_b / con;
    dd = mu_b / (con * con);
  } else {
    const T z = (con - T(2) * theta_b) / theta_b;
    bb = T(0.5) * mu_b * (z * z - T(1)) - mu_b * log_th;
    d = mu_b * (con - T(2) * theta_b) / (theta_b * theta_b);
    dd = mu_b / (theta_b * theta_b);
  }
}

// the barrier's value alone (the same arithmetic as barrier's bb)
template <typename T>
HD T barrier_value(T con, T mu_b, T theta_b, T log_th) {
  if (con > theta_b) return -mu_b * k_log(con);
  const T z = (con - T(2) * theta_b) / theta_b;
  return T(0.5) * mu_b * (z * z - T(1)) - mu_b * log_th;
}

// the barrier's value and first derivative (the same arithmetic as barrier's
// bb and d)
template <typename T>
HD void barrier_grad(T con, T mu_b, T theta_b, T log_th, T& bb, T& d) {
  if (con > theta_b) {
    bb = -mu_b * k_log(con);
    d = -mu_b / con;
  } else {
    const T z = (con - T(2) * theta_b) / theta_b;
    bb = T(0.5) * mu_b * (z * z - T(1)) - mu_b * log_th;
    d = mu_b * (con - T(2) * theta_b) / (theta_b * theta_b);
  }
}

// ---------------------------------------------------------------------------
// The SRBD model in models/srbd_soa.py's evaluation order. Model constants:
// mass, dt, inverse inertia (row-major) and the two foot positions.
// ---------------------------------------------------------------------------
template <typename T> struct Model {
  T mass, dt;
  M3<T> Iinv;
  T pf0[3], pf1[3];
};

template <typename T>
HD Model<T> load_model(const T* kc) {  // kc: mass, dt, Iinv[9], foot[6]
  Model<T> md;
  md.mass = kc[0];
  md.dt = kc[1];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) md.Iinv.m[i][j] = kc[2 + 3 * i + j];
    md.pf0[i] = kc[11 + i];
    md.pf1[i] = kc[14 + i];
  }
  return md;
}

// srbd_soa.dynamics: dx/dt
template <typename T>
HD void soa_dynamics(const Model<T>& md, const T* x, const T* u, T* out) {
  M3<T> R, Jlt;
  chain_lite(x, R, Jlt);
  const M3<T> A = rirt(R, md.Iinv);
  T w[3];
  mv3(A, x + 3, w);
  mv3(Jlt, w, out);
  T d0[3], d1[3], c0[3], c1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d0[i] = md.pf0[i] - x[6 + i];
    d1[i] = md.pf1[i] - x[6 + i];
  }
  cross3(d0, u, c0);
  cross3(d1, u + 6, c1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 + i] = ((u[3 + i] + u[9 + i]) + c0[i]) + c1[i];
    out[6 + i] = x[9 + i];
  }
  out[9] = (u[0] + u[6]) / md.mass;
  out[10] = (u[1] + u[7]) / md.mass;
  out[11] = (u[2] + u[8]) / md.mass + T(-9.8);
}

// srbd_soa.rk4: four dynamics evaluations
template <typename T>
HD void soa_rk4(const Model<T>& md, const T* x, const T* u, T* x_next) {
  T k1[12], k2[12], k3[12], k4[12], xs[12];
  const T hdt = T(0.5) * md.dt;
  soa_dynamics(md, x, u, k1);
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + hdt * k1[i];
  soa_dynamics(md, xs, u, k2);
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + hdt * k2[i];
  soa_dynamics(md, xs, u, k3);
#pragma unroll
  for (int i = 0; i < 12; ++i) xs[i] = x[i] + md.dt * k3[i];
  soa_dynamics(md, xs, u, k4);
  const T dt6 = md.dt / T(6);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    x_next[i] = x[i] + dt6 * (((k1[i] + T(2) * k2[i]) + T(2) * k3[i]) + k4[i]);
}

// srbd_soa.jacobian_blocks: D1, D2 (row-major 3x3) and the generators of
// SF = skew(sF), Sr = skew(sr), Sl = skew(sl). The SO(3) chain is
// srbd_soa.so3_chain with its basis-skew products written out:
// E_a W + W E_a = r e_a' + e_a r' - 2 r_a I, E_a = skew(e_a).
template <typename T>
HD void soa_jacobian_blocks(const Model<T>& md, const T* x, const T* u, M3<T>& D1,
                            M3<T>& D2, T* sF, T* sr, T* sl) {
  const T* r = x;
  const T* l = x + 3;
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

  const M3<T> A = rirt(R, md.Iinv);
  T w[3];
  mv3(A, l, w);

  // djlt_a = -(Jlt (djl_a Jlt)); column a of djlt_w is djlt_a w
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
          // E_a[a+1][a+2] = -1, E_a[a+2][a+1] = +1
          const bool neg = ((a + 1) % 3 == i);
          dj.m[i][j] = (neg ? -c2 : c2) + rb;
        }
      }
    const M3<T> djlt = mul3(Jlt, mul3(dj, Jlt));
    T y[3];
    mv3(djlt, w, y);
#pragma unroll
    for (int i = 0; i < 3; ++i) djw[i][a] = -y[i];
  }

  // D1 = djlt_w + (Jlt (A skew(l) - skew(w))) Jl; row i of A skew(l) is a_i x l
  M3<T> X;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T c[3];
    cross3(A.m[i], l, c);
#pragma unroll
    for (int j = 0; j < 3; ++j) X.m[i][j] = (i == j) ? c[j] : c[j] - skew_at(w, i, j);
  }
  const M3<T> core = mul3(mul3(Jlt, X), Jl);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) D1.m[i][j] = djw[i][j] + core.m[i][j];
  D2 = mul3(Jlt, A);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sF[i] = u[i] + u[6 + i];
    sr[i] = md.pf0[i] - x[6 + i];
    sl[i] = md.pf1[i] - x[6 + i];
  }
}

// entry (i, j) of the dense Jacobians J_fx, J_fu from the blocks
// (srbd_soa.jacobians); the Euler sensitivities are A = I + dt J_fx,
// B = dt J_fu
template <typename T>
HD T jfx(const M3<T>& D1, const M3<T>& D2, const T* sF, int i, int j) {
  if (i < 3) {
    if (j < 3) return D1.m[i][j];
    if (j < 6) return D2.m[i][j - 3];
    return T(0);
  }
  if (i < 6) return (j >= 6 && j < 9) ? skew_at(sF, i - 3, j - 6) : T(0);
  if (i < 9) return (j >= 9 && j - 9 == i - 6) ? T(1) : T(0);
  return T(0);
}

template <typename T>
HD T jfu(const T* sr, const T* sl, T inv_m, int i, int j) {
  if (i >= 3 && i < 6) {
    const int a = i - 3;
    if (j < 3) return skew_at(sr, a, j);
    if (j < 6) return (j - 3 == a) ? T(1) : T(0);
    if (j < 9) return skew_at(sl, a, j - 6);
    return (j - 9 == a) ? T(1) : T(0);
  }
  if (i >= 9) {
    const int a = i - 9;
    if (j < 3) return (j == a) ? inv_m : T(0);
    if (j >= 6 && j < 9) return (j - 6 == a) ? inv_m : T(0);
  }
  return T(0);
}

// max / min that propagate a NaN from either side (jnp.maximum, jnp.minimum)
template <typename T>
HD T nan_max(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
HD T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }

// ---------------------------------------------------------------------------
// Products with the Jacobian blocks of the structured backward-Riccati stage
// (sqp_pallas._riccati_stage_structured), for K1s-B's team form.
// ---------------------------------------------------------------------------

// skew(s)' m = m x s (nonzero terms only)
template <typename T>
HD void skewT_mul(const T* s, T m0, T m1, T m2, T* out) {
  out[0] = s[2] * m1 - s[1] * m2;
  out[1] = s[0] * m2 - s[2] * m0;
  out[2] = s[1] * m0 - s[0] * m1;
}

// (Ju' P)[j][c] from P's column c, pc: rows [Sr' P1 + P3/m | P1 | Sl' P1 + P3/m | P1]
template <typename T>
HD T ju_p(const T* pc, const T* sr, const T* sl, T m_inv, int j) {
  if (j >= 3 && j < 6) return pc[j];
  if (j >= 9) return pc[j - 6];
  const T* s = (j < 3) ? sr : sl;
  const int i = (j < 3) ? j : j - 6;
  T o[3];
  skewT_mul(s, pc[3], pc[4], pc[5], o);
  return o[i] + m_inv * pc[9 + i];
}

// (Jx' M)[i][j] with M = V' (M[r][j] = V[j][r]); rows D1' M0 | D2' M0 | SF' M1 | M2
template <typename T>
HD T jxt_m(const T (&V)[12][12], const T (&D1)[3][3], const T (&D2)[3][3], const T* sF,
           int i, int j) {
  if (i < 3) return D1[0][i] * V[j][0] + D1[1][i] * V[j][1] + D1[2][i] * V[j][2];
  if (i < 6) {
    const int a = i - 3;
    return D2[0][a] * V[j][0] + D2[1][a] * V[j][1] + D2[2][a] * V[j][2];
  }
  if (i >= 9) return V[j][i - 3];
  T o[3];
  skewT_mul(sF, V[j][3], V[j][4], V[j][5], o);
  return o[i - 6];
}

// ---------------------------------------------------------------------------
// The merit of one stage (sqp_pallas._accumulate_merit), accumulated over the
// stages in BACKWARD order, k = N-1 ... 0, seeded with theta = 0,
// phi = phi_N, max|defect| = 0 and min constraint = 1e30 (K3, K4a).
// ---------------------------------------------------------------------------
template <typename T> struct Merit {
  T th, ph, md, mc;
};

template <typename T>
HD Merit<T> merit_seed(T phiN) {
  Merit<T> m;
  m.th = T(0);
  m.ph = phiN;
  m.md = T(0);
  m.mc = T(1e30);
  return m;
}

// bv: defect [12]; con, bb: constraint values and barrier [24]; u, Ru [12];
// e = x - x_ref and q = Q e [12]; each row sum runs left to right
template <typename T>
HD void merit_accumulate(Merit<T>& m, const T* bv, const T* con, const T* bb, const T* u,
                         const T* Ru, const T* e, const T* q) {
  T sb2 = bv[0] * bv[0], su = u[0] * Ru[0], se = e[0] * q[0];
  T mb = bv[0] < 0 ? -bv[0] : bv[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) {
    sb2 = sb2 + bv[i] * bv[i];
    su = su + u[i] * Ru[i];
    se = se + e[i] * q[i];
    mb = nan_max(mb, bv[i] < 0 ? -bv[i] : bv[i]);
  }
  T sbar = bb[0], mcon = con[0];
#pragma unroll
  for (int g = 1; g < 24; ++g) {
    sbar = sbar + bb[g];
    mcon = nan_min(mcon, con[g]);
  }
  m.th = m.th + T(0.5) * sb2;
  m.ph = m.ph + ((sbar + T(0.5) * su) + T(0.5) * se);
  m.md = nan_max(m.md, mb);
  m.mc = nan_min(m.mc, mcon);
}

// ---------------------------------------------------------------------------
// Closed-loop rollout of parked stage products (sqp_pallas._forward_epilogue,
// K4b): du_k = K_k dx_k + kv_k, dx_{k+1} = Acl_k dx_k + bcl_k, and the
// directional derivative dphi = sum_k (dx_k . q_k + du_k . r_k) + dx_N . q_N.
// Stage arrays are [N, 12(, 12), B], indexed (row * B + lane); dx [12] holds
// dx_0 on entry and dx_N on exit. Returns dphi.
// ---------------------------------------------------------------------------
template <typename T>
HD T closed_loop_rollout(const T* Acl, const T* Kp, const T* bcl, const T* kv, const T* q,
                         const T* rf, const T* qN, T* dx, T* dx_out, T* du_out, int N,
                         int B, int b) {
#define AT(ptr, row) (ptr)[(size_t)(row) * B + b]
  T tot = 0;
  for (int k = 0; k < N; ++k) {
    T du[12], dxn[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = AT(Kp, (k * 12 + i) * 12) * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc = acc + AT(Kp, (k * 12 + i) * 12 + j) * dx[j];
      du[i] = acc + AT(kv, k * 12 + i);
      T ax = AT(Acl, (k * 12 + i) * 12) * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) ax = ax + AT(Acl, (k * 12 + i) * 12 + j) * dx[j];
      dxn[i] = ax + AT(bcl, k * 12 + i);
    }
    T px = dx[0] * AT(q, k * 12);
    T pu = du[0] * AT(rf, k * 12);
#pragma unroll
    for (int i = 1; i < 12; ++i) {
      px = px + dx[i] * AT(q, k * 12 + i);
      pu = pu + du[i] * AT(rf, k * 12 + i);
    }
    tot = (k == 0) ? px + pu : tot + (px + pu);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      AT(du_out, k * 12 + i) = du[i];
      AT(dx_out, k * 12 + i) = dxn[i];
      dx[i] = dxn[i];
    }
  }
  T last = dx[0] * qN[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) last = last + dx[i] * qN[i];
  return tot + last;
#undef AT
}

}  // namespace srbd_dev
