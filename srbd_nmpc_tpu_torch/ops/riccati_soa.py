"""Riccati LQR solve of the plain ``xla`` QP route, plain PyTorch.

Counterpart of ``srbd_nmpc_tpu/ops/riccati_soa.py`` (the batched ``xla``
route) and ``srbd_nmpc_tpu/ops/riccati.py`` (the single scenario's solve):
no TPU kernel in the reference either. ``lqr_solve`` takes the engine's
stage-major, batch-last ("SoA") tensors (``A [N, nx, nx, B]``,
``b [N, nx, B]``, ``x0 [nx, B]``) and runs the recursion on batch-first
views (``[B, N, n, m]``) with batched matrix products, Cholesky factors
and triangular solves: a few calls per stage whatever the batch width,
so one scenario (B=1) solves as quickly as the JAX engine's unbatched
path. The recursion is the textbook one the reference's own oracle test
validates (hpipm-cpp/test/ocp_qp_ipm_solver.cpp:61-91), with ``p = -s``:

    P_N = Q_N,  p_N = q_N
    G = R + B' P' B  (+ reg I)          H = S + B' P' A
    K = -G^{-1} H                       k = -G^{-1} (B'(P' b + p') + r)
    P = Q + A' P' A + H' K              p = q + A'(p' + P' b) + H' k
    forward: u = K x + k,  x' = A x + B u + b,  pi = P x + p

Each ``lax.scan`` of the reference is a Python loop over the stages. The
batch-first functions (``factorize``, ``solve_vectors``,
``kkt_residuals``) take any number of leading batch axes. Failure
semantics are JAX's: the Cholesky factor of a G that is not positive
definite is all NaN (``torch.linalg.cholesky_ex``, no host read), and the
NaN reaches the merit, where the engine reports ``NAN_DETECTED``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RiccatiFactors:
    """Matrix part of the recursion, reused across right-hand sides
    (batch-first): P [..., N+1, nx, nx] value Hessians; K [..., N, nu, nx]
    gains; L [..., N, nu, nu] lower Cholesky factors of G; H [..., N, nu, nx]
    = S + B'P'A."""

    P: torch.Tensor
    K: torch.Tensor
    L: torch.Tensor
    H: torch.Tensor


def _cholesky(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; all NaN where G is not positive definite."""
    L, info = torch.linalg.cholesky_ex(G)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def _chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = rhs; rhs is a matrix or (one axis fewer than L) a
    vector."""
    vec = rhs.dim() == L.dim() - 1
    y = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1) if vec else rhs,
                                      upper=False)
    X = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return X.squeeze(-1) if vec else X


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def factorize(A, B, Q, S, R, reg: float = 0.0) -> RiccatiFactors:
    """Backward matrix recursion. A [..., N, nx, nx], B [..., N, nx, nu],
    Q [..., N+1, nx, nx], S [..., N, nu, nx], R [..., N, nu, nu]."""
    N, nu = A.shape[-3], B.shape[-1]
    reg_eye = reg * torch.eye(nu, dtype=A.dtype, device=A.device)
    P_next = Q[..., -1, :, :]
    out = [None] * N
    for i in reversed(range(N)):
        A_i, B_i = A[..., i, :, :], B[..., i, :, :]
        PA = P_next @ A_i
        G = R[..., i, :, :] + B_i.mT @ (P_next @ B_i) + reg_eye
        G = 0.5 * (G + G.mT)
        H = S[..., i, :, :] + B_i.mT @ PA
        L = _cholesky(G)
        K = -_chol_solve(L, H)
        P = Q[..., i, :, :] + A_i.mT @ PA + H.mT @ K
        P_next = 0.5 * (P + P.mT)
        out[i] = (P_next, K, L, H)
    P, K, L, H = (torch.stack(t, dim=-3) for t in zip(*out))
    return RiccatiFactors(P=torch.cat([P, Q[..., -1:, :, :]], dim=-3), K=K,
                          L=L, H=H)


def solve_vectors(fac: RiccatiFactors, A, B, b, q, r, x0
                  ) -> Tuple[torch.Tensor, ...]:
    """Backward vector recursion and forward rollout for one right-hand
    side (batch-first: b [..., N, nx], q [..., N+1, nx], r [..., N, nu],
    x0 [..., nx]). Returns (x [..., N+1, nx], u [..., N, nu],
    pi [..., N+1, nx], p [..., N+1, nx], k [..., N, nu])."""
    N = A.shape[-3]
    ps, ks = [None] * N, [None] * N
    p_next = q[..., -1, :]
    for i in reversed(range(N)):
        Pb_p = _mv(fac.P[..., i + 1, :, :], b[..., i, :]) + p_next
        ks[i] = -_chol_solve(fac.L[..., i, :, :],
                             _mv(B[..., i, :, :].mT, Pb_p) + r[..., i, :])
        p_next = (q[..., i, :] + _mv(A[..., i, :, :].mT, Pb_p)
                  + _mv(fac.H[..., i, :, :].mT, ks[i]))
        ps[i] = p_next
    p = torch.stack(ps + [q[..., -1, :]], dim=-2)
    k = torch.stack(ks, dim=-2)

    x, xs, us = x0, [], []
    for i in range(N):
        u = _mv(fac.K[..., i, :, :], x) + k[..., i, :]
        xs.append(x)
        us.append(u)
        x = _mv(A[..., i, :, :], x) + _mv(B[..., i, :, :], u) + b[..., i, :]
    x = torch.stack(xs + [x], dim=-2)
    pi = _mv(fac.P, x) + p
    return x, torch.stack(us, dim=-2), pi, p, k


def kkt_residuals(A, B, b, Q, S, R, q, r, x, u, pi):
    """Residuals (r_dyn [..., N, nx], r_sx [..., N+1, nx], r_su [..., N, nu])
    of the KKT system at (x, u, pi), batch-first:
      r_dyn_i = A x_i + B u_i + b_i - x_{i+1}
      r_sx_i  = Q x_i + q_i + S' u_i + A' pi_{i+1} - pi_i   (i < N)
      r_sx_N  = Q_N x_N + q_N - pi_N
      r_su_i  = R u_i + r_i + S x_i + B' pi_{i+1}"""
    r_dyn = _mv(A, x[..., :-1, :]) + _mv(B, u) + b - x[..., 1:, :]
    r_sx = _mv(Q, x) + q - pi
    r_sx = torch.cat([r_sx[..., :-1, :] + (_mv(S.mT, u)
                                           + _mv(A.mT, pi[..., 1:, :])),
                      r_sx[..., -1:, :]], dim=-2)
    r_su = (_mv(R, u) + r + _mv(S, x[..., :-1, :])
            + _mv(B.mT, pi[..., 1:, :]))
    return r_dyn, r_sx, r_su


def lqr_solve(A, B, b, Q, S, R, q, r, x0, reg: float = 0.0, refine: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve the equality-constrained OCP-QP given in SoA layout (A
    [N,nx,nx,B], b [N,nx,B], q [N+1,nx,B], x0 [nx,B], ...); returns (x, u,
    pi) in the same layout. Each of the ``refine`` passes solves for the
    correction on the KKT residuals with the same factorization (iterative
    refinement: f64-grade accuracy from f32 factors)."""
    A, B, Q, S, R, b, q, r, x0 = (t.movedim(-1, 0)
                                  for t in (A, B, Q, S, R, b, q, r, x0))
    fac = factorize(A, B, Q, S, R, reg)
    x, u, pi, _, _ = solve_vectors(fac, A, B, b, q, r, x0)
    for _ in range(refine):
        rd, rx, ru = kkt_residuals(A, B, b, Q, S, R, q, r, x, u, pi)
        ex, eu, epi, _, _ = solve_vectors(fac, A, B, rd, rx, ru,
                                          torch.zeros_like(x0))
        x, u, pi = x + ex, u + eu, pi + epi
    return tuple(t.movedim(0, -1) for t in (x, u, pi))
