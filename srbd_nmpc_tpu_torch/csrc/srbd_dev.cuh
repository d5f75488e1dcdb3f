// Device helpers shared by the port's CUDA kernels: scalar math, 3x3 algebra,
// the SO(3) small-angle clamp, the relaxed log barrier, and the SRBD model in
// the evaluation order of srbd_nmpc_tpu_torch/models/srbd_soa.py (its SO(3)
// chain, Jacobian blocks and four-call RK4).
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
#ifdef __CUDACC__
HD float k_rsqrt(float x) { return rsqrtf(x); }
#else
HD float k_rsqrt(float x) { return 1.0f / sqrtf(x); }
#endif
HD double k_rsqrt(double x) { return 1.0 / sqrt(x); }

template <typename T> HD T theta_min_sq();
template <> HD float theta_min_sq<float>() { return 1e-8f; }     // (1e-4)^2
template <> HD double theta_min_sq<double>() { return 1e-20; }   // (1e-10)^2

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

template <typename T>
HD void cross3(const T* a, const T* b, T* out) {
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
// first and second derivative
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

}  // namespace srbd_dev
