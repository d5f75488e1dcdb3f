// K6 · batched LQR solve with S = 0: backward Riccati recursion, then forward
// rollout. One thread per scenario.
//
// Replaces the TPU kernels srbd_nmpc_tpu/ops/riccati_pallas.py::
// _backward_kernel_constq (stage-constant Q/Qf), _backward_kernel (per-stage
// Q) and _forward_kernel (through lqr_solve_pallas). Contract: the plain
// PyTorch versions in srbd_nmpc_tpu_torch/ops/riccati_kernel.py.
//
// What bounds it on the H100: the recursion is strictly sequential over the
// stages, and each stage is a dense 12x12 Riccati update (~6 small matrix
// products, a Cholesky and a 13-column solve: ~11 kFLOP) on ~3 KB of
// per-scenario state (P, P A, H, the factor, the right-hand sides). It is
// latency- and register-bound per thread; the stage inputs (A, B, R: 1.7 KB
// per stage and scenario) are read once per stage, coalesced.
//
// What this simple design does about it: one thread walks one scenario's
// stages N-1 ... 0 with (P, p) in registers/local memory (spills accepted), and
// every global array is indexed ((stage * rows + row) * B + lane), so
// consecutive threads touch consecutive addresses. The backward kernel is a
// template on where Q comes from: two 12x12 matrices in shared memory (Q for
// every stage, Qf for the terminal one) or a per-stage, per-scenario tensor
// [N+1,12,12,B]. The rounding order is the TPU kernel's: G = R + B'PB + reg I
// with no symmetrization of G, a right-looking Cholesky with
// dinv = rsqrt(pivot), and P <- (P_new + P_new') / 2; the build uses
// -fmad=false, so the kernel rounds like the plain version.

#include "srbd_dev.cuh"

namespace k6 {

using namespace srbd_dev;

template <typename T, bool CONST_Q>
HD void backward(const T* A, const T* Bm, const T* bv, const T* Qc, const T* R,
                 const T* q, const T* r, T* Ko, T* ko, int N, int B, int b, T reg) {
#define M(ptr, g, i, j) (ptr)[(((size_t)(g) * 12 + (i)) * 12 + (j)) * B + b]
#define V(ptr, g, i) (ptr)[((size_t)(g) * 12 + (i)) * B + b]
  // Q source: CONST_Q -> Qc = [Q (12x12) | Qf (12x12)] row-major;
  // otherwise Qc = Q [N+1,12,12,B]
  T P[12][12], p[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int j = 0; j < 12; ++j) P[i][j] = CONST_Q ? Qc[144 + 12 * i + j] : M(Qc, N, i, j);
    p[i] = V(q, N, i);
  }

  for (int g = N - 1; g >= 0; --g) {
    // PA = P A
    T PA[12][12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        T acc = P[i][0] * M(A, g, 0, j);
#pragma unroll
        for (int k = 1; k < 12; ++k) acc = acc + P[i][k] * M(A, g, k, j);
        PA[i][j] = acc;
      }

    // G = R + B' (P B) + reg I, lower triangle, one column of P B at a time
    T L[12][12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T pb[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        T acc = P[k][0] * M(Bm, g, 0, j);
#pragma unroll
        for (int m = 1; m < 12; ++m) acc = acc + P[k][m] * M(Bm, g, m, j);
        pb[k] = acc;
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (i < j) continue;
        T acc = M(Bm, g, 0, i) * pb[0];
#pragma unroll
        for (int k = 1; k < 12; ++k) acc = acc + M(Bm, g, k, i) * pb[k];
        T gij = M(R, g, i, j) + acc;
        if (i == j) gij = gij + reg;
        L[i][j] = gij;
      }
    }

    // H = B' (P A); Pb_p = P b + p; Y = [H | B' Pb_p + r]
    T H[12][12], Pbp[12], Y[12][13];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T acc = P[i][0] * V(bv, g, 0);
#pragma unroll
      for (int k = 1; k < 12; ++k) acc = acc + P[i][k] * V(bv, g, k);
      Pbp[i] = acc + p[i];
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        T acc = M(Bm, g, 0, i) * PA[0][j];
#pragma unroll
        for (int k = 1; k < 12; ++k) acc = acc + M(Bm, g, k, i) * PA[k][j];
        H[i][j] = acc;
        Y[i][j] = acc;
      }
      T acc = M(Bm, g, 0, i) * Pbp[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) acc = acc + M(Bm, g, k, i) * Pbp[k];
      Y[i][12] = acc + V(r, g, i);
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
      for (int rr = 0; rr < 12; ++rr)
        if (rr > i) {
#pragma unroll
          for (int c = 0; c < 13; ++c) Y[rr][c] = Y[rr][c] - L[rr][i] * Y[i][c];
        }
    }
#pragma unroll
    for (int i = 11; i >= 0; --i) {
#pragma unroll
      for (int c = 0; c < 13; ++c) Y[i][c] = Y[i][c] * dinv[i];
#pragma unroll
      for (int rr = 0; rr < 12; ++rr)
        if (rr < i) {
#pragma unroll
          for (int c = 0; c < 13; ++c) Y[rr][c] = Y[rr][c] - L[i][rr] * Y[i][c];
        }
    }

    // K = -X[:, :12], k = -X[:, 12]
#pragma unroll
    for (int i = 0; i < 12; ++i) {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        Y[i][j] = -Y[i][j];
        M(Ko, g, i, j) = Y[i][j];
      }
      Y[i][12] = -Y[i][12];
      V(ko, g, i) = Y[i][12];
    }

    // P_new = Q + A'(P A) + H'K (into PA, column by column); p = q + A'Pb_p + H'k
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      T col[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) col[k] = PA[k][j];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        T a = M(A, g, 0, i) * col[0];
#pragma unroll
        for (int k = 1; k < 12; ++k) a = a + M(A, g, k, i) * col[k];
        T h = H[0][i] * Y[0][j];
#pragma unroll
        for (int k = 1; k < 12; ++k) h = h + H[k][i] * Y[k][j];
        const T qij = CONST_Q ? Qc[12 * i + j] : M(Qc, g, i, j);
        PA[i][j] = (qij + a) + h;
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      T a = M(A, g, 0, i) * Pbp[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) a = a + M(A, g, k, i) * Pbp[k];
      T h = H[0][i] * Y[0][12];
#pragma unroll
      for (int k = 1; k < 12; ++k) h = h + H[k][i] * Y[k][12];
      p[i] = (V(q, g, i) + a) + h;
    }
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) P[i][j] = T(0.5) * (PA[i][j] + PA[j][i]);
  }
}

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

#ifdef __CUDACC__

template <bool CONST_Q>
__global__ void riccati_bwd_kernel(const float* A, const float* Bm, const float* bv,
                                   const float* Qc, const float* R, const float* q,
                                   const float* r, float* K, float* k, int N, int B,
                                   float reg) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (CONST_Q) {
    __shared__ float qs[288];
    for (int i = threadIdx.x; i < 288; i += blockDim.x) qs[i] = Qc[i];
    __syncthreads();
    if (lane >= B) return;
    k6::backward<float, true>(A, Bm, bv, qs, R, q, r, K, k, N, B, lane, reg);
  } else {
    if (lane >= B) return;
    k6::backward<float, false>(A, Bm, bv, Qc, R, q, r, K, k, N, B, lane, reg);
  }
}

__global__ void riccati_fwd_kernel(const float* A, const float* Bm, const float* bv,
                                   const float* K, const float* k, const float* x0,
                                   float* x, float* u, int N, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  k6::forward<float>(A, Bm, bv, K, k, x0, x, u, N, B, lane);
}

// Qc: [Q | Qf] (2 x 144 floats) when const_q, else Q [N+1,12,12,B]
extern "C" int srbd_riccati_bwd_launch(const float* A, const float* Bm, const float* bv,
                                       const float* Qc, const float* R, const float* q,
                                       const float* r, float* K, float* k, int N, int B,
                                       float reg, int const_q, int threads, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int blocks = (B + threads - 1) / threads;
  if (const_q)
    riccati_bwd_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        A, Bm, bv, Qc, R, q, r, K, k, N, B, reg);
  else
    riccati_bwd_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        A, Bm, bv, Qc, R, q, r, K, k, N, B, reg);
  return (int)cudaGetLastError();
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

#else  // host build: the same per-scenario bodies over every lane, in f64

using srbd_dev::host_t;  // double, or the op counter under -DSRBD_OPCOUNT

extern "C" int srbd_riccati_bwd_host_f64(const host_t* A, const host_t* Bm,
                                         const host_t* bv, const host_t* Qc,
                                         const host_t* R, const host_t* q,
                                         const host_t* r, host_t* K, host_t* k, int N,
                                         int B, double reg, int const_q) {
  for (int lane = 0; lane < B; ++lane) {
    if (const_q)
      k6::backward<host_t, true>(A, Bm, bv, Qc, R, q, r, K, k, N, B, lane, reg);
    else
      k6::backward<host_t, false>(A, Bm, bv, Qc, R, q, r, K, k, N, B, lane, reg);
  }
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
