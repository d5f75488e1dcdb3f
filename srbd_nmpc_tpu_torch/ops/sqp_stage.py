"""Stage bodies shared by the fused SQP trips (K1 ``ops.sqp_planes``, K3 and
K4 ``ops.sqp_kernel``).

Counterpart of ``srbd_nmpc_tpu/ops/sqp_pallas.py:71-380`` (``_rb``,
``_split_leg_blocks``, ``_backward_stage_structured``,
``_riccati_stage_structured``, ``_accumulate_merit`` and the forward rollout
of ``_forward_epilogue`` / ``_forward_phase``), in batch-last layout
``[n, m, B]``. Every reduction over rows is an explicit left-to-right sum
(``sm.sum_rows``), the order the CUDA kernels accumulate in.

The SRBD Jacobians are sparse: with A = I + dt Jx and B = dt Ju, Jx has
four nonzero 3x3 blocks [D1 D2 0 0; 0 0 SF 0; 0 0 0 I; 0 0 0 0] and Ju
two nonzero row-blocks [0; Sr I Sl I; 0; I/m 0 I/m 0]. Every product
with A or B is written as the row recipes ``_jxt``/``JuT`` below, and P
is kept exactly symmetric, so P Jx = (Jx' P)'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd_soa
from srbd_nmpc_tpu_torch.models.srbd import NX, SRBDParams
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.utils.profiling import span

# constants block of the structured kernels K1 and K3 (offsets match
# csrc/sqp_planes.cu and csrc/sqp_onepass.cu): mass, dt, Iinv[9], foot[6],
# then the leg blocks Ac1, Ac2 [12, 6], bc [24], R, Q, Qf [12, 12]
K_MASS, K_DT, K_IINV, K_FOOT = 0, 1, 2, 11
K_AC1, K_AC2, K_BC = 17, 89, 161
K_R, K_Q, K_QF = 185, 329, 473
K_LEN = 617


def _rb(M: torch.Tensor, i: int) -> torch.Tensor:
    """Row-block i (rows 3i:3i+3) of a [12, ..., B] array."""
    return M[3 * i:3 * i + 3]


def _jxt(D1, D2, SF, Mat):
    """Jx' Mat rows: [D1' M0 | D2' M0 | SF' M1 | M2]."""
    M0, M1, M2 = _rb(Mat, 0), _rb(Mat, 1), _rb(Mat, 2)
    return torch.cat([sm.mtm(D1, M0), sm.mtm(D2, M0), sm.mtm(SF, M1), M2],
                     dim=0)


def _jxtv(D1, D2, SF, v):
    """Jx' v."""
    v0, v1, v2 = _rb(v, 0), _rb(v, 1), _rb(v, 2)
    return torch.cat([sm.mtv(D1, v0), sm.mtv(D2, v0), sm.mtv(SF, v1), v2],
                     dim=0)


def _offdiag(M: torch.Tensor) -> torch.Tensor:
    """max |M| over the two off-diagonal leg blocks of Ac [24, 12] or
    R [12, 12] (a 0-d tensor on M's device)."""
    r, c = M.shape[0] // 2, M.shape[1] // 2
    return torch.maximum(M[:r, c:].abs().max(), M[r:, :c].abs().max())


def _split_leg_blocks(Ac: torch.Tensor, off: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split the leg-block-diagonal constraint matrix Ac [24, 12] into its
    two nonzero [12, 6] diagonal blocks. The structured stage discards the
    off-diagonal blocks, so they must be zero: checked here (one read-back
    on a CUDA tensor, unless the caller passes ``off``, their max |Ac|)."""
    if off is None:
        with span("readback"):
            off = float(_offdiag(Ac))
    if off > 0:
        raise ValueError(
            "structured SQP kernels require a leg-block-diagonal constraint "
            f"matrix; off-diagonal max |Ac| = {off}")
    return Ac[0:12, 0:6], Ac[12:24, 6:12]


def r_leg_diagonal(R_w: torch.Tensor) -> bool:
    """Whether R_w has zero off-diagonal leg blocks, the condition of K1's
    rank-6 stage (JAX ``sqp_planes.py:527-530``; a NaN block counts as
    zero there too)."""
    with span("readback"):
        return not float(_offdiag(R_w)) > 0


@dataclasses.dataclass(frozen=True)
class KernelConstants:
    """K1's and K3's constants block and what K1 decides from it on the
    host: ``block`` [K_LEN] at the ``K_*`` offsets, in the batch's dtype
    (float32, or float64 for K1's float64 form); ``rank6``
    whether R_w is leg-block-diagonal, so that a rank-6 launch runs the 6x6
    stage (else the 12x12 one, as the JAX kernel falls back)."""

    block: torch.Tensor
    rank6: bool


def kernel_constants(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc,
                     dtype: torch.dtype = torch.float32) -> KernelConstants:
    """The constants block of K1 and K3 on the device of ``Ac``, in
    ``dtype`` (the batch's: K1 has a float64 form, K3 has not). Checks
    that ``Ac`` is leg-block-diagonal and whether ``R_w`` is (one read-back
    for both): build it once per solve and hand it to the kernel wrappers
    (``consts=``), so the read-back is not paid per launch."""
    with span("readback"):
        ac_off, r_off = torch.stack([_offdiag(Ac).double(),
                                     _offdiag(R_w).double()]).tolist()
    Ac1, Ac2 = _split_leg_blocks(Ac, ac_off)
    parts = [params.mass.reshape(1), params.dt.reshape(1),
             params.inertia_inv.reshape(9), params.foot_pos.reshape(6),
             Ac1.reshape(72), Ac2.reshape(72), bc.reshape(24),
             R_w.reshape(144), Q_w.reshape(144), Qf_w.reshape(144)]
    k = torch.cat([t.to(device=Ac.device, dtype=dtype)
                   for t in parts]).contiguous()
    assert k.numel() == K_LEN
    return KernelConstants(block=k, rank6=not r_off > 0)


def _riccati_stage_structured(dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, Reff,
                              reff, q, b, P, p, reg: float,
                              with_acl: bool = True,
                              return_factor: bool = False):
    """One structured backward-Riccati stage. Returns (P_new, p_new, Acl,
    K, bcl, kv); with ``with_acl=False`` Acl and bcl are None (K1 rolls
    forward from the structured blocks instead).

    G = Reff + B'P B + reg I is factored once (12x12 Cholesky); one 13-rhs
    forward substitution Y = L^-1 [H | rv] gives the Schur downdates
    (H'G^-1 H = Y'Y, via ``gram``), so P_new/p_new never wait on the
    backward substitution that yields the gains [K | kv].

    ``return_factor``: the factor-parking form (K1 with ``factor=True``)
    returns (P_new, p_new, L, dinv, Yh, yv) before the backward
    substitution; the caller forms du = -L'^-1 (Yh dx + yv) in its
    rollout."""
    dtype, dev = P.dtype, P.device
    Bt = P.shape[-1]

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

    V = _jxt(D1, D2, SF, P)                            # Jx' P
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

    P_new = (Qw_b + P + dt * (M + V) + (dt * dt) * _jxt(D1, D2, SF, M)
             - sm.gram(Yh))
    P_new = 0.5 * (P_new + P_new.transpose(0, 1))
    p_new = q + Pb_p + dt * _jxtv(D1, D2, SF, Pb_p) - sm.mtv(Yh, yv)
    if return_factor:
        return P_new, p_new, L, dinv, Yh, yv

    KV = -sm.bwd_subst(L, dinv, Y13)
    K, kv = KV[:, 0:12], KV[:, 12]
    if not with_acl:
        return P_new, p_new, None, K, None, kv

    # Acl = A + B K; A assembled by concatenation only (I + dt Jx)
    z3 = torch.zeros((3, 3, Bt), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)[:, :, None].expand(3, 3, Bt)

    def rows(*blocks):
        return torch.cat(blocks, dim=1)

    A = torch.cat([rows(I3 + dt * D1, dt * D2, z3, z3),
                   rows(z3, I3, dt * SF, z3),
                   rows(z3, z3, I3, dt * I3),
                   rows(z3, z3, z3, I3)], dim=0)
    Kr0, Kr1, Kr2, Kr3 = (_rb(K, i) for i in range(4))
    zr = torch.zeros((3, NX, Bt), dtype=dtype, device=dev)
    BK = torch.cat([zr, dt * (sm.mm(Sr, Kr0) + Kr1 + sm.mm(Sl, Kr2) + Kr3),
                    zr, (dt * m_inv) * (Kr0 + Kr2)], dim=0)
    kv0, kv1, kv2, kv3 = (_rb(kv, i) for i in range(4))
    zv = torch.zeros((3, Bt), dtype=dtype, device=dev)
    Bkv = torch.cat([zv, dt * (sm.mv(Sr, kv0) + kv1 + sm.mv(Sl, kv2) + kv3),
                     zv, (dt * m_inv) * (kv0 + kv2)], dim=0)
    return P_new, p_new, A + BK, K, b + Bkv, kv


def _backward_stage_structured(params: SRBDParams, Ac1_b, Ac2_b, bc_col, Rw_b,
                               Qw_b, x, xn, u, xr, P, p, reg: float,
                               mu_b: float, theta_b: float):
    """One linearize + structured backward-Riccati stage at (x, u), next
    state xn: the linearization is ``srbd_soa.jacobian_blocks`` plus the
    four-call ``srbd_soa.rk4`` (separate SO(3) chains). ``Ac1_b``/``Ac2_b``
    are the leg blocks [12, 6, B]. Returns (P_new, p_new, Acl, K, bcl, kv,
    q, reff, b, con, b_bar, Ru)."""
    dt = params.dt
    m_inv = 1.0 / params.mass
    D1, D2, SF, Sr, Sl = srbd_soa.jacobian_blocks(params, x, u)
    b = srbd_soa.rk4(params, x, u) - xn

    con = torch.cat([sm.mv(Ac1_b, u[0:6]), sm.mv(Ac2_b, u[6:12])],
                    dim=0) + bc_col
    b_bar, db, ddb = relaxed_log_barrier(con, mu_b, theta_b)
    C11 = sm.mtm(Ac1_b, Ac1_b * ddb[0:12, None])       # [6, 6, B]
    C22 = sm.mtm(Ac2_b, Ac2_b * ddb[12:24, None])
    z66 = torch.zeros_like(C11)
    Reff = Rw_b + torch.cat([torch.cat([C11, z66], dim=1),
                             torch.cat([z66, C22], dim=1)], dim=0)
    Ru = sm.mv(Rw_b, u)
    reff = Ru + torch.cat([sm.mtv(Ac1_b, db[0:12]), sm.mtv(Ac2_b, db[12:24])],
                          dim=0)
    q = sm.mv(Qw_b, x - xr)

    P_new, p_new, Acl, K, bcl, kv = _riccati_stage_structured(
        dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, Reff, reff, q, b, P, p, reg)
    return P_new, p_new, Acl, K, bcl, kv, q, reff, b, con, b_bar, Ru


def _accumulate_merit(acc: Optional[Tuple[torch.Tensor, ...]], b, con, b_bar,
                      u, Ru, x, xr, q, phiN) -> Tuple[torch.Tensor, ...]:
    """Add one stage to the merit (theta, phi, max|defect|, min constraint)
    [B] each. Stages are visited in backward order; ``acc=None`` seeds
    with (0, phiN, 0, 1e30) as the TPU kernels' first grid step does."""
    if acc is None:
        zero = torch.zeros_like(phiN)
        acc = (zero, phiN, zero, torch.full_like(phiN, 1e30))
    th, ph, md, mc = acc
    th_part = 0.5 * sm.sum_rows(b * b)
    ph_part = (sm.sum_rows(b_bar) + 0.5 * sm.sum_rows(u * Ru)
               + 0.5 * sm.sum_rows((x - xr) * q))
    return (th + th_part, ph + ph_part,
            torch.maximum(md, b.abs().amax(dim=0)),
            torch.minimum(mc, con.amin(dim=0)))


def _forward_rollout(dx0, Acl: List, K: List, bcl: List, kv: List, q: List,
                     reff: List, qN):
    """Closed-loop rollout of the parked stage products: du_k = K dx_k + kv,
    dx_{k+1} = Acl dx_k + bcl, dphi = sum_k dx_k.q_k + du_k.r_k +
    dx_N.q_N. Returns (dx [N,12,B] for stages 1..N, du [N,12,B], dphi)."""
    dx = dx0
    dxs, dus = [], []
    tot = None
    for k in range(len(K)):
        du = sm.mv(K[k], dx) + kv[k]
        dxn = sm.mv(Acl[k], dx) + bcl[k]
        part = sm.sum_rows(dx * q[k]) + sm.sum_rows(du * reff[k])
        tot = part if tot is None else tot + part
        dus.append(du)
        dxs.append(dxn)
        dx = dxn
    return torch.stack(dxs), torch.stack(dus), tot + sm.sum_rows(dx * qN)
