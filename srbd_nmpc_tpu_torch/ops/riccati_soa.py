"""Batched Riccati recursion in batch-last ("SoA") layout, plain PyTorch.

Counterpart of ``srbd_nmpc_tpu/ops/riccati_soa.py``: the ``qp_kernel="xla"``
route's QP solve (no TPU kernel in the reference either). Stage matrices are
``[N, n, m, B]``; every product is an ``ops.smallmat`` k-loop, and each
``lax.scan`` of the reference is a Python loop over stages.

``factorize`` (matrix recursion), ``solve_vectors`` (vector recursion and
rollout) and ``lqr_solve`` with iterative refinement on the KKT residuals,
reusing the factorization.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.ops import smallmat as sm


@dataclasses.dataclass(frozen=True)
class RiccatiFactorsSoA:
    """P [N+1,nx,nx,B]; K [N,nu,nx,B]; L (chol of G) [N,nu,nu,B];
    dinv [N,nu,B]; H [N,nu,nx,B]."""

    P: torch.Tensor
    K: torch.Tensor
    L: torch.Tensor
    dinv: torch.Tensor
    H: torch.Tensor


def _per_stage(fn, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([fn(a[t], v[t]) for t in range(a.shape[0])])


def factorize(A, B, Q, S, R, reg: float = 0.0) -> RiccatiFactorsSoA:
    """Backward matrix recursion. A [N,nx,nx,B], Q [N+1,nx,nx,B],
    S [N,nu,nx,B], R [N,nu,nu,B]."""
    N = A.shape[0]
    out = [None] * N
    P_next = Q[-1]
    for i in reversed(range(N)):
        PA = sm.mm(P_next, A[i])
        PB = sm.mm(P_next, B[i])
        G = sm.add_diag(sm.sym(R[i] + sm.mtm(B[i], PB)), reg)
        H = S[i] + sm.mtm(B[i], PA)
        L, dinv = sm.cholesky(G)
        K = -sm.chol_solve(L, dinv, H)
        P_next = sm.sym(Q[i] + sm.mtm(A[i], PA) + sm.mtm(H, K))
        out[i] = (P_next, K, L, dinv, H)
    P, K, L, dinv, H = (torch.stack(t) for t in zip(*out))
    return RiccatiFactorsSoA(P=torch.cat([P, Q[-1:]], dim=0), K=K, L=L,
                             dinv=dinv, H=H)


def solve_vectors(fac: RiccatiFactorsSoA, A, B, b, q, r, x0):
    """Backward vector recursion and forward rollout for one right-hand
    side. b [N,nx,B], q [N+1,nx,B], r [N,nu,B], x0 [nx,B]. Returns
    (x [N+1,nx,B], u [N,nu,B], pi [N+1,nx,B], p, k)."""
    N = A.shape[0]
    ps, ks = [None] * N, [None] * N
    p_next = q[-1]
    for i in reversed(range(N)):
        Pb_p = sm.mv(fac.P[i + 1], b[i]) + p_next
        ks[i] = -sm.chol_solve_vec(fac.L[i], fac.dinv[i],
                                   sm.mtv(B[i], Pb_p) + r[i])
        p_next = q[i] + sm.mtv(A[i], Pb_p) + sm.mtv(fac.H[i], ks[i])
        ps[i] = p_next
    p = torch.stack(ps + [q[-1]])
    k = torch.stack(ks)

    x = x0
    xs, us = [], []
    for i in range(N):
        u = sm.mv(fac.K[i], x) + k[i]
        xs.append(x)
        us.append(u)
        x = sm.mv(A[i], x) + sm.mv(B[i], u) + b[i]
    x = torch.stack(xs + [x])
    pi = _per_stage(sm.mv, fac.P, x) + p
    return x, torch.stack(us), pi, p, k


def kkt_residuals_soa(A, B, b, Q, S, R, q, r, x, u, pi):
    """Residuals (r_dyn, r_sx, r_su) of the KKT system at (x, u, pi)."""
    r_dyn = _per_stage(sm.mv, A, x[:-1]) + _per_stage(sm.mv, B, u) + b - x[1:]
    r_sx = _per_stage(sm.mv, Q, x) + q - pi
    r_sx = torch.cat([r_sx[:-1] + (_per_stage(sm.mtv, S, u)
                                   + _per_stage(sm.mtv, A, pi[1:])),
                      r_sx[-1:]], dim=0)
    r_su = (_per_stage(sm.mv, R, u) + r + _per_stage(sm.mv, S, x[:-1])
            + _per_stage(sm.mtv, B, pi[1:]))
    return r_dyn, r_sx, r_su


def lqr_solve(A, B, b, Q, S, R, q, r, x0, reg: float = 0.0, refine: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve the equality-constrained OCP-QP; returns (x, u, pi). Each of
    the ``refine`` passes solves for the correction on the KKT residuals
    with the same factorization."""
    fac = factorize(A, B, Q, S, R, reg)
    x, u, pi, _, _ = solve_vectors(fac, A, B, b, q, r, x0)
    for _ in range(refine):
        rd, rx, ru = kkt_residuals_soa(A, B, b, Q, S, R, q, r, x, u, pi)
        ex, eu, epi, _, _ = solve_vectors(fac, A, B, rd, rx, ru,
                                          torch.zeros_like(x0))
        x, u, pi = x + ex, u + eu, pi + epi
    return x, u, pi
