"""Structured backward-Riccati stage of the fused SQP trip.

Counterpart of ``srbd_nmpc_tpu/ops/sqp_pallas.py:71-111, 179-274``
(``_rb``, ``_split_leg_blocks``, ``_riccati_stage_structured`` in its
``with_acl=False`` K/kv form), in batch-last layout ``[n, m, B]``.

The SRBD Jacobians are sparse: with A = I + dt Jx and B = dt Ju, Jx has
four nonzero 3x3 blocks [D1 D2 0 0; 0 0 SF 0; 0 0 0 I; 0 0 0 0] and Ju
two nonzero row-blocks [0; Sr I Sl I; 0; I/m 0 I/m 0]. Every product
with A or B is written as the row recipes ``JxT``/``JuT`` below, and P
is kept exactly symmetric, so P Jx = (Jx' P)'.
"""

from __future__ import annotations

from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models.srbd import NX
from srbd_nmpc_tpu_torch.ops import smallmat as sm


def _rb(M: torch.Tensor, i: int) -> torch.Tensor:
    """Row-block i (rows 3i:3i+3) of a [12, ..., B] array."""
    return M[3 * i:3 * i + 3]


def _split_leg_blocks(Ac: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split the leg-block-diagonal constraint matrix Ac [24, 12] into its
    two nonzero [12, 6] diagonal blocks. The structured stage discards the
    off-diagonal blocks, so they must be zero: checked here."""
    off = max(float(Ac[0:12, 6:12].abs().max()),
              float(Ac[12:24, 0:6].abs().max()))
    if off > 0:
        raise ValueError(
            "structured SQP kernels require a leg-block-diagonal constraint "
            f"matrix; off-diagonal max |Ac| = {off}")
    return Ac[0:12, 0:6], Ac[12:24, 6:12]


def _riccati_stage_structured(dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, Reff,
                              reff, q, b, P, p, reg: float):
    """One structured backward-Riccati stage. Returns (P_new, p_new, K, kv).

    G = Reff + B'P B + reg I is factored once (12x12 Cholesky); one 13-rhs
    forward substitution Y = L^-1 [H | rv] gives the Schur downdates
    (H'G^-1 H = Y'Y, via ``gram``), so P_new/p_new never wait on the
    backward substitution that yields the gains [K | kv]."""
    dtype, dev = P.dtype, P.device

    def JuT(Mat):
        """Ju' @ Mat rows: [Sr' M1 + M3/m | M1 | Sl' M1 + M3/m | M1]."""
        M1, M3 = _rb(Mat, 1), _rb(Mat, 3)
        a = sm.mtm(Sr, M1) + m_inv * M3
        c = sm.mtm(Sl, M1) + m_inv * M3
        return torch.cat([a, M1, c, M1], dim=0)

    def JuTv(v):
        v1, v3 = _rb(v, 1), _rb(v, 3)
        a = sm.mtv(Sr, v1) + m_inv * v3
        c = sm.mtv(Sl, v1) + m_inv * v3
        return torch.cat([a, v1, c, v1], dim=0)

    def JxT(Mat):
        M0, M1, M2 = _rb(Mat, 0), _rb(Mat, 1), _rb(Mat, 2)
        return torch.cat([sm.mtm(D1, M0), sm.mtm(D2, M0),
                          sm.mtm(SF, M1), M2], dim=0)

    def JxTv(v):
        v0, v1, v2 = _rb(v, 0), _rb(v, 1), _rb(v, 2)
        return torch.cat([sm.mtv(D1, v0), sm.mtv(D2, v0),
                          sm.mtv(SF, v1), v2], dim=0)

    V = JxT(P)                                         # Jx' P
    U = JuT(P)                                         # Ju' P
    M = V.transpose(0, 1)                              # P Jx  (P = P')
    PA = P + dt * M
    eye_reg = (torch.as_tensor(reg, dtype=dtype, device=dev)
               * torch.eye(NX, dtype=dtype, device=dev)[:, :, None])
    G = Reff + (dt * dt) * JuT(U.transpose(0, 1)) + eye_reg
    H = dt * JuT(PA)                                   # B'P A
    L, dinv = sm.cholesky(G)
    Pb_p = sm.mv(P, b) + p
    rhs = torch.cat([H, (dt * JuTv(Pb_p) + reff)[:, None]], dim=1)
    Y13 = sm.fwd_subst(L, dinv, rhs)                   # [12, 13, B]
    Yh = Y13[:, 0:12]                                  # L^-1 H
    yv = Y13[:, 12]

    P_new = (Qw_b + P + dt * (M + V) + (dt * dt) * JxT(M) - sm.gram(Yh))
    P_new = 0.5 * (P_new + P_new.transpose(0, 1))
    p_new = q + Pb_p + dt * JxTv(Pb_p) - sm.mtv(Yh, yv)

    KV = -sm.bwd_subst(L, dinv, Y13)
    return P_new, p_new, KV[:, 0:12], KV[:, 12]
