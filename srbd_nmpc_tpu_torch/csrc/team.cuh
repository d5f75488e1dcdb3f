// Helpers of the kernels that spread one scenario's Riccati stage over a
// team of W threads, with the stage's matrices in a per-team array in shared
// memory: K1s-B and its rank-6 and factor forms (k1s_passes.cuh; the gains
// form is also K3's Riccati pass) and K6's team backward pass
// (riccati.cu; its Acl form is also K4a's).
//
// A team body is written once for the card and the host. On the card each
// member runs its own share of a step (TEAM_FOR binds t = lane) and
// TEAM_SYNC() is a barrier of the team's lanes (__syncwarp(mask)); on the host
// the members run one after another, in reverse order with rev, so that a
// step must read nothing that another member writes in the same step (the
// reversed order catches such a race). The enclosing function names the
// team's lane, W, mask and rev.
//
// Every entry is formed by one member with one fixed expression and sum
// order, so no sum is split between members and a team rounds alike at
// every width and member order.

#pragma once

#include "srbd_dev.cuh"

namespace srbd_team {

using srbd_dev::k_rsqrt;

// entry (r, c <= r) of a lower triangle stored row by row
HD constexpr int li(int r, int c) { return r * (r + 1) / 2 + c; }

// row r and column c <= r of the e-th entry of a lower triangle taken row by
// row (e < 78; 8e + 1 is exact in float and sqrtf rounds correctly, so a
// perfect square gives its exact root)
HD void tri(int e, int& r, int& c) {
  r = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  c = e - r * (r + 1) / 2;
}

// TEAM_FOR(t) { step }: member t's share of one step. MINE(a): member t's own
// slot of a per-member array a[SLOTS] that a member keeps from one step to the
// next (registers on the card).
#ifdef __CUDA_ARCH__
#define TEAM_FOR(t) if (const int t = lane; true)
#define TEAM_SYNC() __syncwarp(mask)
#define MINE(a) (a)[0]
constexpr int SLOTS = 1;
#else
#define TEAM_FOR(t) \
  for (int m_ = 0; m_ < W; ++m_) if (const int t = rev ? W - 1 - m_ : m_; true)
#define TEAM_SYNC() ((void)0)
#define MINE(a) (a)[t]
constexpr int SLOTS = 32;
#endif

// one round of a step's work items, unrolled: item e = t + q W of n
#define TEAM_ITEMS(e, n)                                   \
  _Pragma("unroll") for (int q_ = 0; q_ < 13; ++q_)        \
    if (const int e = t + q_ * W; q_ * W < (n) && e < (n))

// the lanes of a warp that team `team_in_warp` of width W holds
HD unsigned team_mask(int W, int team_in_warp) {
  return W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (team_in_warp * W);
}

// Right-looking Cholesky of the 12x12 lower triangle L (78 entries, li),
// dinv = rsqrt(pivot): each row's entries a member. Column 0 is scaled
// first; then each step j updates the trailing rows r > j by L[r][j]
// (scaled) and scales column j + 1 with the pivot every
// member forms from L[j+1][j+1] as its owner would, so the owner leaves that
// entry unwritten (the scaled diagonal is never read). One barrier a column;
// ends with one.
template <typename T>
HD void team_cholesky(T* L, T* dinv, int lane, int W, unsigned mask, bool rev) {
  (void)lane;
  (void)mask;
  (void)rev;
  TEAM_FOR(t) {
    const T d0 = k_rsqrt(L[0]);
    if (t == 0) dinv[0] = d0;
    for (int r = 1 + t; r < 12; r += W) L[li(r, 0)] = L[li(r, 0)] * d0;
  }
  TEAM_SYNC();
#pragma unroll
  for (int j = 0; j < 11; ++j) {
    TEAM_FOR(t) {
      const T lj = L[li(j + 1, j)];
      const T dn = k_rsqrt(L[li(j + 1, j + 1)] - lj * lj);
      if (t == 0) dinv[j + 1] = dn;
      for (int r = j + 2 + t; r < 12; r += W) {
        T* row = L + li(r, 0);
        const T lrj = row[j];
        row[j + 1] = (row[j + 1] - lrj * lj) * dn;
#pragma unroll
        for (int c = j + 2; c < 12; ++c)
          if (c <= r) row[c] = row[c] - lrj * L[li(c, j)];
      }
    }
    TEAM_SYNC();
  }
}

// forward substitution Y <- L^-1 Y on the 13 columns of Y [12][13], one
// column per member; ends with a barrier
template <typename T>
HD void team_forward_subst(const T* L, const T* dinv, T (*Y)[13], int lane, int W,
                           unsigned mask, bool rev) {
  (void)lane;
  (void)mask;
  (void)rev;
  TEAM_FOR(t) {
    TEAM_ITEMS(c, 13) {
      T y[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) y[i] = Y[i][c];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        y[i] = y[i] * dinv[i];
#pragma unroll
        for (int r = i + 1; r < 12; ++r) y[r] = y[r] - L[li(r, i)] * y[i];
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) Y[i][c] = y[i];
    }
  }
  TEAM_SYNC();
}

// column c of the back substitution L' X = Y, into y[12] (Y's column c in)
template <typename T>
HD void back_subst_column(const T* L, const T* dinv, const T (*Y)[13], int c, T (&y)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) y[i] = Y[i][c];
#pragma unroll
  for (int i = 11; i >= 0; --i) {
    y[i] = y[i] * dinv[i];
#pragma unroll
    for (int r = 0; r < i; ++r) y[r] = y[r] - L[li(i, r)] * y[i];
  }
}

}  // namespace srbd_team
