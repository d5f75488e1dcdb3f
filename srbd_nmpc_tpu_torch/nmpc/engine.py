"""SQP NMPC solves: one scenario, and batches in the speculative loop with
straggler compaction or the iteration-synchronous loop with its three QP
routes.

Counterpart of ``srbd_nmpc_tpu/nmpc/engine.py``, rank-polymorphic like it:
a state ``x [N+1, 12]`` is one scenario, ``x [B, N+1, 12]`` a batch.
Per-scenario semantics are the reference's sequential SQP with a
backtracking filter line search (persistent alpha, convergence test
``dphi > -1e-3 and theta < 1e-6``, NMPC_solver.cpp:143-274), exactly as in
the JAX engine.

- The single scenario (``x [N+1, 12]``, the reference's one-robot
  workload) is a batch of one on the plain ``xla`` route of the
  synchronous loop below, whatever ``qp_kernel`` says: plain PyTorch on
  every device and dtype, as the JAX engine leaves its unbatched path to
  XLA.
- ``_solve_batched_soa_spec`` (the default ``NmpcConfig``): each while-trip
  launches ONE fused SQP trip at every live scenario's next line-search
  candidate ``x + alpha dx``: its merit decides the filter acceptance, and
  on acceptance its QP solution is the next iteration's direction. The
  trip is ``ops.sqp_planes`` (kernel K1; its factor-parking body with
  ``park_factor=True``) with ``planes=True``, and the dense
  ``ops.sqp_kernel`` trip (K3a, bootstrapped by K3b) with
  ``planes=False``. As the live set shrinks, the carry is compacted into
  narrower tiers with the sorted lane permutes of ``ops.permute`` (K2).
- ``_solve_batched_soa`` (every other batched configuration): each SQP
  iteration linearizes and solves the QP, then runs the line search to its
  end. The QP route (``_qp_route``) is ``fused`` (K1 at alpha = 0, or K3b
  with ``planes=False``), ``pallas`` (K5 ``models.srbd_linearize``, then
  K6 ``ops.riccati_kernel``) or ``xla`` (plain PyTorch,
  ``ops.riccati_soa`` with iterative refinement); the line search's merit
  is K7a (``models.merit_kernel``) on the first two and plain on ``xla``.
  ``sensitivity="exact"`` takes the ``xla`` route.
- ``_merit_fast`` on a float32 batch with a shared reference runs kernel
  K7b (``models.merit_kernel.merit``).

Public layout is the JAX engine's: states are ``x [B, N+1, 12]``,
``u [B, N, 12]``, ``alpha [B]``; inside the solve the trajectories are
stage-major with the batch last (``[N+1, 12, B]``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import numbers
from typing import Optional, Tuple

import numpy as np
import torch

from srbd_nmpc_tpu_torch.models import merit_kernel, srbd, srbd_linearize
from srbd_nmpc_tpu_torch.models import srbd_soa
from srbd_nmpc_tpu_torch.ocpqp.data import OcpQp
from srbd_nmpc_tpu_torch.ops import permute, riccati_kernel, riccati_soa
from srbd_nmpc_tpu_torch.ops import sqp_kernel, sqp_planes, sqp_stage
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.utils.device import (DeviceLike, pin_float32,
                                              resolve_device)
from srbd_nmpc_tpu_torch.utils.profiling import span

# Engine status codes (IpmStatus encoding). STATUS_RUNNING doubles as
# MAX_ITER_REACHED: a scenario that never leaves it ran out of iterations.
STATUS_SUCCESS = 0
STATUS_RUNNING = 1
STATUS_MIN_STEP = 2          # line search stalled at alpha_min
STATUS_NAN_DETECTED = 3


@dataclasses.dataclass(frozen=True)
class NmpcConfig:
    """Engine configuration: the JAX ``NmpcConfig``'s fields, defaults and
    checks. Options outside the ported slice are accepted here (so a
    configuration carries across unchanged) and raise
    ``NotImplementedError`` in ``solve``."""

    N: int = 20
    sqp_max_iter: int = 15
    mu_barrier: float = 0.1
    theta_barrier: float = 5.0
    sensitivity: str = "euler"

    theta_max: float = 1e-6
    theta_min: float = 5e-10
    eta: float = 1e-4
    beta_phi: float = 1e-6
    beta_theta: float = 1e-6
    beta_alpha: float = 0.5
    alpha_min: float = 1e-4
    persistent_alpha: bool = True

    reg: float = 1e-9
    refine: int = 0
    qp_kernel: str = "auto"
    pscan_min_N: int = 1 << 30
    # granularity of the compaction tier widths (a tier engages only when
    # its width is a multiple of it); the CUDA kernels' block sizes are
    # separate constants in their wrappers
    pallas_block: int = 256
    speculative: bool = True
    fold_forward: bool = True
    planes: bool = True
    compact: bool = True
    compact_tiers: tuple = (2, 8, 32)
    # K1's factor-parking body (ops.sqp_planes factor=True) on the planes
    # trips of both loops; no effect with planes=False, as in JAX
    park_factor: bool = False

    conv_dphi: float = -1e-3
    conv_theta: float = 1e-6

    def __post_init__(self):
        if self.qp_kernel in ("pscan", "fused") and self.refine > 0:
            raise ValueError(
                f"qp_kernel={self.qp_kernel!r} does not support refine > 0 "
                "(iterative refinement is only implemented in the "
                "sequential XLA Riccati kernel); use qp_kernel='auto'/'xla' "
                "or set refine=0")
        if self.qp_kernel in ("pallas", "fused") and self.sensitivity != "euler":
            raise ValueError(
                f"qp_kernel={self.qp_kernel!r} implements the reference's "
                "Euler sensitivities only; use sensitivity='euler' or "
                "qp_kernel='auto'/'xla'")


@dataclasses.dataclass(frozen=True)
class NmpcWeights:
    """Cost weights: Q = diag(Q_yaml), R = R_yaml * I, Qf = N * diag(Qf_yaml)."""

    Q: torch.Tensor   # [nx, nx]
    R: torch.Tensor   # [nu, nu]
    Qf: torch.Tensor  # [nx, nx]

    @staticmethod
    def create(Q_diag, R_scalar, Qf_diag, N: int, dtype=torch.float32,
               device: DeviceLike = None) -> "NmpcWeights":
        dev = resolve_device(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=dev)

        return NmpcWeights(
            Q=torch.diag(t(Q_diag)),
            R=t(R_scalar) * torch.eye(srbd.NU, dtype=dtype, device=dev),
            Qf=t(N) * torch.diag(t(Qf_diag)),
        )


@dataclasses.dataclass(frozen=True)
class NmpcState:
    """Per-scenario SQP iterate; leaves may carry a leading batch axis."""

    x: torch.Tensor      # [..., N+1, nx]
    u: torch.Tensor      # [..., N, nu]
    alpha: torch.Tensor  # [...]

    @staticmethod
    def initial(N: int, dtype=torch.float32, device: DeviceLike = None
                ) -> "NmpcState":
        """x = 0, u = 100, alpha = 1 (the reference's cold start)."""
        dev = resolve_device(device)
        return NmpcState(
            x=torch.zeros((N + 1, srbd.NX), dtype=dtype, device=dev),
            u=100.0 * torch.ones((N, srbd.NU), dtype=dtype, device=dev),
            alpha=torch.tensor(1.0, dtype=dtype, device=dev),
        )


@dataclasses.dataclass(frozen=True)
class NmpcInfo:
    """Per-scenario diagnostics. ``status``: 0 SUCCESS, 1 MAX_ITER_REACHED,
    2 MIN_STEP_LENGTH_REACHED, 3 NAN_DETECTED. ``ls_trips``: in the
    speculative loop the fused SQP-trip launches, in the synchronous loop
    the line-search trips summed over the SQP iterations (every scenario of
    a batch pays the slowest's)."""

    converged: torch.Tensor
    sqp_iters: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    dphi: torch.Tensor
    alpha: torch.Tensor
    max_defect: torch.Tensor
    min_constraint: torch.Tensor
    status: torch.Tensor
    ls_trips: torch.Tensor

    def pretty(self) -> str:
        """Human-readable report (the reference's printOptimizationInfo),
        aggregated over the batch when one is present."""
        def a(t):
            return np.asarray(t.detach().cpu())

        names = {0: "SUCCESS", 1: "MAX_ITER_REACHED",
                 2: "MIN_STEP_LENGTH_REACHED", 3: "NAN_DETECTED"}
        conv = a(self.converged)
        stat = a(self.status)
        lines = ["-----------------------"]
        if conv.ndim == 0:
            lines += [
                f"status      : {names.get(int(stat), int(stat))}",
                f"sqp_loop    : {int(a(self.sqp_iters))}",
                f"ls_trips    : {int(a(self.ls_trips))}",
                f"phi         : {float(a(self.phi)):.6e}",
                f"dphi        : {float(a(self.dphi)):.6e}",
                f"theta       : {float(a(self.theta)):.6e}",
                f"alpha       : {float(a(self.alpha)):.6e}",
                "max dynamic equation violation    : "
                f"{float(a(self.max_defect)):.6e}",
                "min friction cone constraint value: "
                f"{float(a(self.min_constraint)):.6e}",
            ]
        else:
            n = conv.size
            counts = {names[k]: int(np.sum(stat == k)) for k in names
                      if np.any(stat == k)}
            lines += [
                f"scenarios   : {n}  (converged {int(conv.sum())}/{n})",
                f"status      : {counts}",
                f"sqp_loop    : mean {float(np.mean(a(self.sqp_iters))):.2f}"
                f"  max {int(np.max(a(self.sqp_iters)))}",
                f"ls_trips    : max {int(np.max(a(self.ls_trips)))}",
                f"phi         : max {float(np.max(a(self.phi))):.6e}",
                f"theta       : max {float(np.max(a(self.theta))):.6e}",
                f"alpha       : min {float(np.min(a(self.alpha))):.6e}",
                "max dynamic equation violation    : "
                f"{float(np.max(a(self.max_defect))):.6e}",
                "min friction cone constraint value: "
                f"{float(np.min(a(self.min_constraint))):.6e}",
            ]
        return "\n".join(lines)


def _accept(cfg: NmpcConfig, theta_a, phi_a, alpha, theta0, phi0, dphi):
    """Filter acceptance 3-case rule (reference NMPC_solver.cpp:200-264)."""
    case_infeasible = theta_a > cfg.theta_max
    acc_infeasible = theta_a < (1.0 - cfg.beta_theta) * theta0
    case_small = (torch.maximum(theta_a, theta0) < cfg.theta_min) & (dphi < 0.0)
    acc_small = phi_a < phi0 + cfg.eta * alpha * dphi
    acc_mixed = (phi_a < phi0 - cfg.beta_phi * theta0) | (
        theta_a < (1.0 - cfg.beta_theta) * theta0)
    return torch.where(case_infeasible, acc_infeasible,
                       torch.where(case_small, acc_small, acc_mixed))


def _qp_route(cfg: NmpcConfig) -> str:
    """The QP route of an SQP iteration, as the JAX ``_sqp_step_soa`` picks
    it: ``fused`` for ``qp_kernel="fused"``, or ``"auto"`` with ``refine ==
    0`` and Euler sensitivities (the port reads ``"auto"`` so on every
    device); ``pallas`` for ``qp_kernel="pallas"`` with ``refine == 0``;
    ``xla`` otherwise (``"xla"``, or ``"auto"``/``"pallas"`` with
    ``refine > 0``)."""
    if cfg.qp_kernel == "fused" or (cfg.qp_kernel == "auto" and cfg.refine == 0
                                    and cfg.sensitivity == "euler"):
        return "fused"
    if cfg.qp_kernel == "pallas" and cfg.refine == 0:
        return "pallas"
    return "xla"


def _check_slice(cfg: NmpcConfig, state: NmpcState) -> None:
    """Reject every configuration the port does not run yet."""
    def todo(what, item):
        raise NotImplementedError(
            f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")

    if state.x.dim() not in (2, 3):
        todo(f"a state of rank {state.x.dim()} (one scenario [N+1, 12] or a "
             "batch [B, N+1, 12] only)",
             'Queue 1, "States with more than one batch axis"')
    if cfg.qp_kernel == "pscan" or (cfg.qp_kernel == "auto" and cfg.refine == 0
                                    and cfg.N >= cfg.pscan_min_N):
        todo("the associative-scan Riccati (qp_kernel='pscan', or "
             "N >= pscan_min_N)", 'Queue 1, "ops/riccati_pscan.py"')
    if state.x.dim() == 2:
        return   # the single scenario runs no kernel: any dtype and device
    if (state.x.device.type == "cuda" and state.x.dtype != torch.float32
            and _qp_route(cfg) != "xla"
            and not (state.x.dtype == torch.float64 and _f64_route(cfg))):
        todo(f"{state.x.dtype} on CUDA on this route (float64 runs K1's "
             "gains body and K2 on the speculative fused planes route; the "
             "other kernels are float32)", '"f64 kernels"')


def _f64_route(cfg: NmpcConfig) -> bool:
    """Whether a float64 batch on CUDA runs kernels that have a float64
    form: the speculative loop on the fused planes route with K1's gains
    body (the default ``NmpcConfig``), whose trips are K1 and whose
    compaction crossings are K2."""
    return (cfg.speculative and _qp_route(cfg) == "fused" and cfg.planes
            and not cfg.park_factor)


def solve(params: srbd.SRBDParams, weights: NmpcWeights, cfg: NmpcConfig,
          state: NmpcState, x0: torch.Tensor, x_ref: torch.Tensor
          ) -> Tuple[NmpcState, NmpcInfo]:
    """NMPC solve: SQP iterations until every scenario converged, stalled
    or hit ``sqp_max_iter``. One scenario: ``state.x`` [N+1, nx], ``x0``
    [nx], ``x_ref`` [N+1, nx]. A batch: ``state`` leaves carry a leading
    batch axis [B]; ``x0`` is [B, nx]; ``x_ref`` is [N+1, nx] (shared) or
    [B, N+1, nx].

    On CUDA, TF32 is switched off for matmuls and convolutions first: the
    ``theta < 1e-6`` convergence test must never see TF32 rounding.

    Under a profiler the solve is the span ``srbd::solve``, and every span
    of its loops (``utils/profiling``) nests inside it."""
    with span("solve"):
        _check_slice(cfg, state)
        pin_float32(state.x.device)
        if state.x.dim() == 2:
            return _unbatch(*_solve_batched_soa(
                params, weights, _single_cfg(cfg), _batch_of_one(state),
                x0[None], x_ref))
        if cfg.speculative and _qp_route(cfg) == "fused":
            return _solve_batched_soa_spec(params, weights, cfg, state, x0,
                                           x_ref)
        return _solve_batched_soa(params, weights, cfg, state, x0, x_ref)


@dataclasses.dataclass(frozen=True)
class _KernelConstants:
    """The constants of one solve's kernels: the constraint rows (Ac, bc)
    and the constants blocks of the kernels its route runs, None where it
    runs none: ``fused`` K1's and K3's (``sqp_stage.kernel_constants``),
    ``linearize`` K5's (``pallas``), ``merit`` K7a's (``fused`` and
    ``pallas``)."""

    Ac: torch.Tensor
    bc: torch.Tensor
    fused: Optional[sqp_stage.KernelConstants] = None
    linearize: Optional[torch.Tensor] = None
    merit: Optional[torch.Tensor] = None


def _kernel_constants(params, weights, cfg, device, merit=True,
                      dtype=torch.float32):
    """The kernels' constants, built once per solve on CUDA (K1's and K3's
    leg-block-diagonal check costs a device read-back); None elsewhere
    (the plain versions take the parameters themselves). ``merit``: whether
    the solve's loop runs K7a (the synchronous loop does, the speculative
    loop does not); ``dtype``: the batch's, K1's and K3's block's."""
    route = _qp_route(cfg)
    if route == "xla" or torch.device(device).type != "cuda":
        return None
    Ac, bc = srbd.constraint_matrix(params)
    k7 = (merit_kernel.kernel_constants(params, weights.Q, weights.Qf,
                                        weights.R, Ac, bc) if merit else None)
    if route == "fused":
        return _KernelConstants(Ac, bc, merit=k7, fused=sqp_stage.
                                kernel_constants(params, weights.Q, weights.Qf,
                                                 weights.R, Ac, bc, dtype))
    return _KernelConstants(Ac, bc, merit=k7, linearize=srbd_linearize.
                            kernel_constants(params, weights.Q, weights.R, Ac,
                                             bc))


def _constraints(params, consts):
    """(Ac, bc): the solve's, or built from the parameters without it."""
    if consts is None:
        return srbd.constraint_matrix(params)
    return consts.Ac, consts.bc


def _soa_inputs(cfg: NmpcConfig, state: NmpcState, x0, x_ref):
    """States to stage-major SoA: xa [N+1,12,B], us [N,12,B], x0s [12,B],
    xra [N+1,12,B] (a shared reference is broadcast)."""
    Bn = state.x.shape[0]
    xa = state.x.permute(1, 2, 0).contiguous()
    us = state.u.permute(1, 2, 0).contiguous()
    x0s = x0.transpose(0, 1).contiguous()
    if x_ref.dim() == 2:
        xra = (x_ref[:, :, None].expand(cfg.N + 1, srbd.NX, Bn)
               .to(state.x.dtype).contiguous())
    else:
        xra = x_ref.permute(1, 2, 0).contiguous()
    return xa, us, x0s, xra


def _stage_linearization(lin, params, weights, cfg, xa, us, xra,
                         consts=None):
    """Run a stage linearization ``lin`` (``srbd_linearize.linearize``, with
    the solve's ``consts`` from ``_kernel_constants``, or its plain version)
    and add the terminal gradient and the merit at the current iterate from
    its partials (JAX ``_linearize_pallas_soa``)."""
    Ac, bc = _constraints(params, consts)
    kw = {} if consts is None else dict(consts=consts.linearize)
    A, Bm, b, q_run, r_eff, R_eff, mer = lin(
        params, weights.Q, weights.R, Ac, bc, xa[:-1], xa[1:], us, xra[:-1],
        cfg.mu_barrier, cfg.theta_barrier, **kw)
    eN = xa[-1] - xra[-1]
    q_term = sm.mv(weights.Qf.to(xa.dtype)[:, :, None], eN)
    q = torch.cat([q_run, q_term[None]], dim=0)
    theta = mer[:, 0].sum(dim=0)
    phi = ((mer[:, 1] + mer[:, 4] + mer[:, 5]).sum(dim=0)
           + 0.5 * (eN * q_term).sum(dim=0))
    aux = (theta, phi, mer[:, 3].amax(dim=0), mer[:, 2].amin(dim=0))
    return A, Bm, b, R_eff, q, r_eff, aux


def _linearize_pallas_soa(params, weights, cfg, xa, us, xra, consts=None):
    """The ``pallas`` route's linearization: kernel K5 on CUDA tensors
    (``consts``: ``_kernel_constants``). Returns (A, B, b, R_eff, q, r_eff,
    (theta, phi, max|defect|, min constraint))."""
    return _stage_linearization(srbd_linearize.linearize, params, weights,
                                cfg, xa, us, xra, consts)


def _rk4_jacobians_soa(params, x, u):
    """The exact sensitivities in ``srbd_soa``'s layout: x, u [12, N, B]
    -> (A, B) [12, 12, N, B]."""
    A, Bm = srbd.rk4_jacobians(params, x.permute(2, 1, 0), u.permute(2, 1, 0))
    return A.permute(2, 3, 1, 0), Bm.permute(2, 3, 1, 0)


def _linearize_soa(params, weights, cfg, xa, us, xra):
    """The ``xla`` route's linearization, plain PyTorch on every device.
    Returns (A, B, b, Q, S, R_eff, q, r_eff, aux) with the stage-constant
    Q/Qf broadcast to [N+1,12,12,B] and S = 0, as ``ops.riccati_soa`` takes
    them. With ``sensitivity="exact"`` A and B are the RK4 map's Jacobians
    (``srbd.rk4_jacobians``, ``torch.func.jacfwd``) in place of the Euler
    ones; everything else is the same."""
    if cfg.sensitivity not in ("euler", "exact"):
        raise ValueError(f"unknown sensitivity mode: {cfg.sensitivity!r}")
    lin = srbd_linearize.linearize_ref
    if cfg.sensitivity == "exact":
        lin = functools.partial(lin, jac=_rk4_jacobians_soa)
    A, Bm, b, R_eff, q, r_eff, aux = _stage_linearization(
        lin, params, weights, cfg, xa, us, xra)
    N, Bn = cfg.N, xa.shape[-1]
    Qw = weights.Q.to(xa.dtype)[None, :, :, None].expand(N, srbd.NX, srbd.NX, Bn)
    Qf = weights.Qf.to(xa.dtype)[None, :, :, None].expand(1, srbd.NX, srbd.NX, Bn)
    Q = torch.cat([Qw, Qf], dim=0)
    S = torch.zeros((N, srbd.NU, srbd.NX, Bn), dtype=xa.dtype, device=xa.device)
    return A, Bm, b, Q, S, R_eff, q, r_eff, aux


def _merit_soa(params, weights, cfg, xa, us, xra):
    """(theta, phi) [B] at an SoA iterate, plain PyTorch: the ``xla``
    route's line-search merit."""
    x_in = xa[:-1].transpose(0, 1)                     # [12, N, B]
    x_nx = xa[1:].transpose(0, 1)
    u_in = us.transpose(0, 1)
    d = x_nx - srbd_soa.rk4(params, x_in, u_in)
    theta = 0.5 * (d * d).sum(dim=(0, 1))

    dtype = xa.dtype
    ex = xa - xra
    Qe = torch.einsum("ij,njb->nib", weights.Q.to(dtype), ex[:-1])
    phi_x = 0.5 * (ex[:-1] * Qe).sum(dim=(0, 1))
    eN = ex[-1]
    QfeN = torch.einsum("ij,jb->ib", weights.Qf.to(dtype), eN)
    phi_N = 0.5 * (eN * QfeN).sum(dim=0)

    Ac, bc = srbd.constraint_matrix(params)
    con = torch.einsum("gi,nib->ngb", Ac.to(dtype), us) + bc.to(dtype)[:, None]
    b_bar, _, _ = relaxed_log_barrier(con, cfg.mu_barrier, cfg.theta_barrier)
    Ru = torch.einsum("ij,njb->nib", weights.R.to(dtype), us)
    phi_u = b_bar.sum(dim=(0, 1)) + 0.5 * (us * Ru).sum(dim=(0, 1))
    return theta, phi_x + phi_N + phi_u


def merit(params: srbd.SRBDParams, weights: NmpcWeights, cfg: NmpcConfig,
          x: torch.Tensor, u: torch.Tensor, x_ref: torch.Tensor,
          with_grad: bool = False):
    """Merit pair (theta, phi) per scenario, plain PyTorch: theta =
    1/2 sum_k |f_k|^2 over the shooting defects, phi = tracking + barrier
    + input cost (NMPC_solver.cpp:152-189). Returns (theta, phi, defects
    [..., N, nx], con [..., N, 24]) and, with ``with_grad``, the gradients
    Jphi_x [..., N+1, nx] and Jphi_u [..., N, nu]. The RK4 defects are
    evaluated in SoA layout (``srbd_soa.rk4``) for either rank."""
    Ac, bc = srbd.constraint_matrix(params)
    dtype = x.dtype
    Q, Qf, R = (w.to(dtype) for w in (weights.Q, weights.Qf, weights.R))
    Ac, bc = Ac.to(dtype), bc.to(dtype)

    xs = x[..., :-1, :].movedim(-1, 0)                 # SoA [nx, ..., N]
    xn = x[..., 1:, :].movedim(-1, 0)
    defects = (xn - srbd_soa.rk4(params, xs, u.movedim(-1, 0))).movedim(0, -1)
    theta = 0.5 * torch.sum(defects * defects, dim=(-2, -1))

    ex = x - x_ref.to(dtype)
    Qx = torch.einsum("...ni,ij->...nj", ex[..., :-1, :], Q)
    phi_x = 0.5 * torch.sum(ex[..., :-1, :] * Qx, dim=(-2, -1))
    eN = ex[..., -1, :]
    QfeN = torch.einsum("...i,ij->...j", eN, Qf)
    phi_N = 0.5 * torch.sum(eN * QfeN, dim=-1)

    con = torch.einsum("...ni,gi->...ng", u, Ac) + bc     # [..., N, 24]
    b_bar, db_bar, _ = relaxed_log_barrier(con, cfg.mu_barrier,
                                           cfg.theta_barrier)
    Ru = torch.einsum("...ni,ij->...nj", u, R)
    phi_u = (torch.sum(b_bar, dim=(-2, -1))
             + 0.5 * torch.sum(u * Ru, dim=(-2, -1)))

    phi = phi_x + phi_N + phi_u
    if not with_grad:
        return theta, phi, defects, con
    Jphi_x = torch.cat([Qx, QfeN[..., None, :]], dim=-2)
    Jphi_u = torch.einsum("...ng,gi->...ni", db_bar, Ac) + Ru
    return theta, phi, defects, con, Jphi_x, Jphi_u


def _pallas_eligible(cfg: NmpcConfig, batch: int, dtype: torch.dtype) -> bool:
    """Whether a batched merit takes kernel K7b: ``qp_kernel="pallas"``, or
    ``"auto"`` on a float32 batch at a width that is a multiple of
    ``pallas_block`` (the port reads ``"auto"`` so on every device, as
    ``_qp_route`` does; a float64 batch takes the plain merit there, as the
    JAX engine does off the TPU, since the kernel is float32)."""
    return cfg.qp_kernel == "pallas" or (
        cfg.qp_kernel == "auto" and dtype == torch.float32
        and batch % cfg.pallas_block == 0)


def _merit_fast(params: srbd.SRBDParams, weights: NmpcWeights,
                cfg: NmpcConfig, x: torch.Tensor, u: torch.Tensor,
                x_ref: torch.Tensor, with_grad: bool = False):
    """Merit with reduced diagnostics: (theta, phi, max|defect|,
    min(con)[, Jphi_x, Jphi_u]). A batch ``x [B, N+1, nx]`` with a shared
    ``x_ref [N+1, nx]`` takes kernel K7b when ``_pallas_eligible`` (its
    variant with or without gradients, as ``with_grad`` asks); everything
    else takes the plain ``merit``."""
    if (x.dim() == 3 and x_ref.dim() == 2
            and _pallas_eligible(cfg, x.shape[0], x.dtype)):
        Bn = x.shape[0]
        Ac, bc = srbd.constraint_matrix(params)
        xs = x.permute(1, 2, 0).contiguous()
        us = u.permute(1, 2, 0).contiguous()
        xr = (x_ref.to(x.dtype)[:, :, None].expand(cfg.N + 1, srbd.NX, Bn)
              .contiguous())
        th, ph, Jx, Ju, md, mc = merit_kernel.merit(
            params, weights.Q, weights.Qf, weights.R, Ac, bc, xs, us, xr,
            cfg.mu_barrier, cfg.theta_barrier, with_grad=with_grad)
        if with_grad:
            return th, ph, md, mc, Jx.permute(2, 0, 1), Ju.permute(2, 0, 1)
        return th, ph, md, mc

    out = merit(params, weights, cfg, x, u, x_ref, with_grad=with_grad)
    theta, phi, defects, con = out[:4]
    md = torch.amax(torch.abs(defects), dim=(-2, -1))
    mc = torch.amin(con, dim=(-2, -1))
    if with_grad:
        return theta, phi, md, mc, out[4], out[5]
    return theta, phi, md, mc


def linearize(params: srbd.SRBDParams, weights: NmpcWeights, cfg: NmpcConfig,
              state: NmpcState, x_ref: torch.Tensor) -> OcpQp:
    """The delta-form OCP-QP around the current trajectory
    (prepareQpStructures, NMPC_solver.cpp:276-314): dynamics rows from the
    shooting linearization, the barrier's curvature folded into
    (R_eff, r_eff), no hard constraint rows. The ``xla`` route's SoA
    linearization, returned as [N, ...] for one scenario and [B, N, ...]
    for a batch."""
    single = state.x.dim() == 2
    if single:
        state = _batch_of_one(state)
    xa, us, _, xra = _soa_inputs(cfg, state, state.x[:, 0], x_ref)
    A, B, b, Q, S, R, q, r, _ = _linearize_soa(params, weights, cfg, xa, us,
                                               xra)

    def f(z):   # [N, ..., B] -> [B, N, ...]
        z = z.movedim(-1, 0)
        return z[0] if single else z

    return OcpQp(A=f(A), B=f(B), b=f(b), Q=f(Q), S=f(S), R=f(R), q=f(q),
                 r=f(r))


def _merit_candidate_soa(params, weights, cfg, xa, us, xra, dx, du, alpha,
                         use_kernel: bool, consts=None):
    """(theta, phi) [B] at the candidate (xa + alpha dx, us + alpha du):
    kernel K7a on the ``fused`` and ``pallas`` routes (the candidate is
    formed inside the kernel; ``consts``: ``_kernel_constants``), the plain
    merit on ``xla``."""
    if use_kernel:
        Ac, bc = _constraints(params, consts)
        return merit_kernel.merit_alpha(
            params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us, xra,
            dx, du, alpha, cfg.mu_barrier, cfg.theta_barrier,
            consts=None if consts is None else consts.merit)
    a = alpha[None, None, :]
    return _merit_soa(params, weights, cfg, xa + a * dx, us + a * du, xra)


def _line_search_soa(params, weights, cfg, xa, us, alpha0, xra, dx, du,
                     theta0, phi0, dphi, active0, use_kernel: bool,
                     consts=None):
    """Backtracking filter line search, per scenario the reference's loop
    (NMPC_solver.cpp:200-264): evaluate at alpha, accept or multiply alpha
    by beta_alpha. The JAX ``lax.while_loop`` is a host loop here with one
    device sync per trip (its condition, the span ``srbd::readback``). The
    accepted trajectory is formed once afterwards as xa + alpha dx. Each
    trip is the span ``srbd::ls_trip``. Returns (xa', us', alpha', trips)."""
    alpha = alpha0
    accepted = torch.zeros(alpha0.shape, dtype=torch.bool, device=xa.device)
    trips = 0
    while True:
        searching = active0 & ~accepted & (alpha > cfg.alpha_min)
        with span("readback"):
            go = bool(searching.any())
        if not go:
            break
        with span("ls_trip"):
            theta_a, phi_a = _merit_candidate_soa(
                params, weights, cfg, xa, us, xra, dx, du, alpha, use_kernel,
                consts)
            ok = (_accept(cfg, theta_a, phi_a, alpha, theta0, phi0, dphi)
                  & searching)
            alpha = torch.where(searching & ~ok, cfg.beta_alpha * alpha,
                                alpha)
            accepted = accepted | ok
        trips += 1
    am = accepted[None, None, :]
    af = alpha[None, None, :]
    # where-guarded (not alpha * 0): a frozen or NaN scenario's dx may be NaN
    return (torch.where(am, xa + af * dx, xa), torch.where(am, us + af * du, us),
            alpha, trips)


def _sqp_step_soa(params, weights, cfg, xa, us, alpha, x0s, xra, active,
                  consts=None):
    """One SQP iteration in SoA layout (xa [N+1,12,B], us [N,12,B],
    x0s [12,B], xra [N+1,12,B]): linearize, solve the QP on the route
    ``_qp_route`` picks, line-search. ``consts``: ``_kernel_constants``.
    Returns (xa', us', alpha', (theta0, phi0, dphi, max_defect, min_con,
    nan, trips))."""
    Bn = xa.shape[-1]
    route = _qp_route(cfg)
    dx0s = x0s - xa[0]
    if route == "fused":
        Ac, bc = _constraints(params, consts)
        head = (params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us, xra)
        fused = None if consts is None else consts.fused
        if cfg.planes:
            dx, du, dphi, aux = sqp_planes.sqp_qp_solve_onepass_planes(
                *head, torch.zeros_like(xa), torch.zeros_like(us),
                torch.zeros(Bn, dtype=xa.dtype, device=xa.device), x0s,
                cfg.mu_barrier, cfg.theta_barrier, reg=cfg.reg,
                factor=cfg.park_factor, consts=fused)
        else:
            dx, du, dphi, aux = sqp_kernel.sqp_qp_solve_onepass(
                *head, dx0s, cfg.mu_barrier, cfg.theta_barrier, reg=cfg.reg,
                fold=cfg.fold_forward, consts=fused)
    elif route == "pallas":
        A, Bm, b, R, q, r, aux = _linearize_pallas_soa(
            params, weights, cfg, xa, us, xra, consts)
        dx, du = riccati_kernel.lqr_solve(
            A, Bm, b, (weights.Q, weights.Qf), R, q, r, dx0s, reg=cfg.reg)
        dphi = (dx * q).sum(dim=(0, 1)) + (du * r).sum(dim=(0, 1))
    else:
        A, Bm, b, Q, S, R, q, r, aux = _linearize_soa(
            params, weights, cfg, xa, us, xra)
        dx, du, _ = riccati_soa.lqr_solve(A, Bm, b, Q, S, R, q, r, dx0s,
                                          reg=cfg.reg, refine=cfg.refine)
        dphi = (dx * q).sum(dim=(0, 1)) + (du * r).sum(dim=(0, 1))
    theta0, phi0, max_defect, min_con = aux

    nan = ~torch.isfinite(theta0 + phi0 + dphi)
    alpha0 = alpha if cfg.persistent_alpha else torch.ones_like(alpha)
    xa_n, us_n, alpha_n, trips = _line_search_soa(
        params, weights, cfg, xa, us, alpha0, xra, dx, du, theta0, phi0, dphi,
        active & ~nan, route != "xla", consts)
    return xa_n, us_n, alpha_n, (theta0, phi0, dphi, max_defect, min_con, nan,
                                 trips)


def _step_status(cfg, theta0, dphi, nan):
    converged = (dphi > cfg.conv_dphi) & (theta0 < cfg.conv_theta)
    status = torch.where(converged, STATUS_SUCCESS,
                         torch.where(nan, STATUS_NAN_DETECTED, STATUS_RUNNING))
    return converged, status.to(torch.int32)


def sqp_step(params: srbd.SRBDParams, weights: NmpcWeights, cfg: NmpcConfig,
             state: NmpcState, x0: torch.Tensor, x_ref: torch.Tensor,
             active=None) -> Tuple[NmpcState, NmpcInfo]:
    """One SQP iteration: linearize, QP-solve, line-search, convergence
    test (the body of NMPC_solver.cpp:367-374), for one scenario or a
    batch. ``active`` masks the scenarios still iterating (None = all)."""
    _check_slice(cfg, state)
    pin_float32(state.x.device)
    if state.x.dim() == 2:
        return _unbatch(*sqp_step(
            params, weights, _single_cfg(cfg), _batch_of_one(state), x0[None],
            x_ref, None if active is None else active.reshape(1)))
    Bn = state.x.shape[0]
    xa, us, x0s, xra = _soa_inputs(cfg, state, x0, x_ref)
    if active is None:
        active = torch.ones((Bn,), dtype=torch.bool, device=xa.device)
    xa_n, us_n, alpha_n, aux = _sqp_step_soa(
        params, weights, cfg, xa, us, state.alpha, x0s, xra, active,
        _kernel_constants(params, weights, cfg, xa.device))
    theta0, phi0, dphi, max_defect, min_con, nan, trips = aux
    converged, status = _step_status(cfg, theta0, dphi, nan)
    new_state = NmpcState(x=xa_n.permute(2, 0, 1).contiguous(),
                          u=us_n.permute(2, 0, 1).contiguous(), alpha=alpha_n)
    info = NmpcInfo(
        converged=converged,
        sqp_iters=torch.ones((Bn,), dtype=torch.int32, device=xa.device),
        theta=theta0, phi=phi0, dphi=dphi, alpha=alpha_n,
        max_defect=max_defect, min_constraint=min_con, status=status,
        ls_trips=torch.full((Bn,), trips, dtype=torch.int32,
                            device=xa.device))
    return new_state, info


def _solve_batched_soa(params, weights, cfg, state, x0, x_ref):
    """Iteration-synchronous batched solve, trajectories in SoA for the
    whole descent. The JAX ``lax.while_loop`` over SQP iterations is a host
    loop: its condition (iterations left and a scenario still RUNNING) is
    read back once per iteration, and the line search inside reads its own
    condition once per trip. Each iteration is the span
    ``srbd::sqp_iter[B]``, each read-back ``srbd::readback``."""
    Bn = state.x.shape[0]
    dtype, dev = state.x.dtype, state.x.device
    xa, us, x0s, xra = _soa_inputs(cfg, state, x0, x_ref)
    alpha = state.alpha
    consts = _kernel_constants(params, weights, cfg, dev)
    i32 = torch.int32
    inf = torch.full((Bn,), math.inf, dtype=dtype, device=dev)
    info = NmpcInfo(
        converged=torch.zeros((Bn,), dtype=torch.bool, device=dev),
        sqp_iters=torch.zeros((Bn,), dtype=i32, device=dev),
        theta=inf, phi=inf, dphi=-inf, alpha=state.alpha,
        max_defect=inf, min_constraint=-inf,
        status=torch.full((Bn,), STATUS_RUNNING, dtype=i32, device=dev),
        ls_trips=torch.zeros((Bn,), dtype=i32, device=dev))

    it = 0
    while it < cfg.sqp_max_iter:
        with span("readback"):
            running = bool((info.status == STATUS_RUNNING).any())
        if not running:
            break
        with span("sqp_iter", Bn):
            act = info.status == STATUS_RUNNING
            xa_n, us_n, alpha_n, aux = _sqp_step_soa(
                params, weights, cfg, xa, us, alpha, x0s, xra, act, consts)
            theta0, phi0, dphi, max_defect, min_con, nan, trips = aux
            converged, step_status = _step_status(cfg, theta0, dphi, nan)

            m = act[None, None, :]
            xa = torch.where(m, xa_n, xa)
            us = torch.where(m, us_n, us)
            alpha = torch.where(act, alpha_n, alpha)

            def upd(new, old):
                return torch.where(act, new, old)

            info = NmpcInfo(
                converged=info.converged | (converged & act),
                sqp_iters=info.sqp_iters + act.to(i32),
                theta=upd(theta0, info.theta),
                phi=upd(phi0, info.phi),
                dphi=upd(dphi, info.dphi),
                alpha=upd(alpha, info.alpha),
                max_defect=upd(max_defect, info.max_defect),
                min_constraint=upd(min_con, info.min_constraint),
                status=torch.where(act, step_status, info.status),
                ls_trips=info.ls_trips + trips,
            )
        it += 1

    stalled = (info.status == STATUS_RUNNING) & (info.alpha <= cfg.alpha_min)
    info = dataclasses.replace(
        info, status=torch.where(stalled, STATUS_MIN_STEP, info.status).to(i32))
    state_f = NmpcState(x=xa.permute(2, 0, 1).contiguous(),
                        u=us.permute(2, 0, 1).contiguous(), alpha=alpha)
    return state_f, info


def _single_cfg(cfg: NmpcConfig) -> NmpcConfig:
    """One scenario takes the plain ``xla`` route, as the JAX engine's
    unbatched path runs no kernel."""
    return dataclasses.replace(cfg, qp_kernel="xla")


def _batch_of_one(state: NmpcState) -> NmpcState:
    return NmpcState(x=state.x[None], u=state.u[None],
                     alpha=state.alpha.reshape(1))


def _unbatch(state: NmpcState, info: NmpcInfo) -> Tuple[NmpcState, NmpcInfo]:
    return (NmpcState(x=state.x[0], u=state.u[0], alpha=state.alpha[0]),
            NmpcInfo(**{f.name: getattr(info, f.name)[0]
                        for f in dataclasses.fields(info)}))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # trajectory-sized arrays (ndim >= 2) go through the K2 kernel on CUDA;
    # the [B]-sized bookkeeping (bool/int32/float vectors) is left to
    # index_select, as the JAX engine leaves it to jnp.take
    return permute.take_lanes(a, idx) if a.dim() >= 2 else a.index_select(0, idx)


def _put(dst: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
         ) -> torch.Tensor:
    if dst.dim() >= 2:
        return permute.set_lanes(dst, src, idx)
    return dst.index_copy(0, idx, src)


def _solve_batched_soa_spec(params, weights, cfg, state, x0, x_ref):
    """Speculative-acceptance batched solve with phase-structured straggler
    compaction (see the module docstring and the JAX engine's
    ``_solve_batched_soa_spec``).

    Each ``lax.while_loop`` phase of the JAX engine is a host ``while``
    loop here: its condition ``n_live > thresh and trips < trip_cap`` is
    read back once per trip (one device sync per trip, the span
    ``srbd::readback``). The bootstrap and each trip are the span
    ``srbd::trip[<width>]``, at the width the trip launches; each tier
    crossing's K2 calls, the gather into the tier and the scatter back out
    of it, the span ``srbd::compact[<width>]``, at the tier's width."""
    Bn = state.x.shape[0]
    dtype, dev = state.x.dtype, state.x.device
    N = cfg.N
    xa0 = state.x.permute(1, 2, 0).contiguous()
    us0 = state.u.permute(1, 2, 0).contiguous()
    x0s = x0.transpose(0, 1).contiguous()
    shared_ref = x_ref.dim() == 2

    def _xra_at(width):
        return (x_ref[:, :, None].expand(N + 1, srbd.NX, width)
                .to(dtype).contiguous())

    xra = _xra_at(Bn) if shared_ref else x_ref.permute(1, 2, 0).contiguous()
    consts = _kernel_constants(params, weights, cfg, dev, merit=False,
                               dtype=dtype)
    Ac, bc = _constraints(params, consts)
    head = (params, weights.Q, weights.Qf, weights.R, Ac, bc)
    kw = dict(reg=cfg.reg, consts=None if consts is None else consts.fused)

    if cfg.planes:
        # one plane-phase kernel (K1) serves the bootstrap (alpha = 0) and
        # the candidate trips; park_factor picks its factor-parking body
        def _boot(xa, us):
            return sqp_planes.sqp_qp_solve_onepass_planes(
                *head, xa, us, xra, torch.zeros_like(xa), torch.zeros_like(us),
                torch.zeros(Bn, dtype=dtype, device=dev), x0s,
                cfg.mu_barrier, cfg.theta_barrier, factor=cfg.park_factor,
                **kw)

        def _cand_at(xa, us, dx_p, du_p, alpha_cand, xra_, x0s_):
            return sqp_planes.sqp_qp_solve_onepass_planes(
                *head, xa, us, xra_, dx_p, du_p, alpha_cand, x0s_,
                cfg.mu_barrier, cfg.theta_barrier, factor=cfg.park_factor,
                **kw)
    else:
        # dense one-pass trips: K3b at the iterate, K3a at the candidates
        def _boot(xa, us):
            return sqp_kernel.sqp_qp_solve_onepass(
                *head, xa, us, xra, x0s - xa[0], cfg.mu_barrier,
                cfg.theta_barrier, fold=cfg.fold_forward, **kw)

        def _cand_at(xa, us, dx_p, du_p, alpha_cand, xra_, x0s_):
            return sqp_kernel.sqp_qp_solve_onepass_cand(
                *head, xa, us, xra_, dx_p, du_p, alpha_cand, x0s_,
                cfg.mu_barrier, cfg.theta_barrier, fold=cfg.fold_forward,
                **kw)

    tiers = set()
    if cfg.compact:
        for f in cfg.compact_tiers:
            # numpy integers count (bools are below 2)
            if not isinstance(f, numbers.Integral) or f < 2:
                raise ValueError(
                    f"compact_tiers must be ints >= 2, got {f!r} in "
                    f"{cfg.compact_tiers!r}")
            Bc = Bn // int(f)
            if Bc >= cfg.pallas_block and Bc % cfg.pallas_block == 0:
                tiers.add(Bc)
    # a repeated width would only add a gather/scatter crossing
    tiers = sorted(tiers, reverse=True)

    # ---- bootstrap: iteration 1's linearize + QP at the initial iterate --
    with span("trip", Bn):
        dx_p, du_p, dphi_p, aux = _boot(xa0, us0)
    th_p, ph_p, md_p, mc_p = aux
    nan0 = ~torch.isfinite(th_p + ph_p + dphi_p)
    conv_p = (dphi_p > cfg.conv_dphi) & (th_p < cfg.conv_theta)
    live = ~nan0
    i32 = torch.int32
    status = torch.where(nan0, STATUS_NAN_DETECTED, STATUS_RUNNING).to(i32)
    iters = torch.where(nan0, 1, 0).to(i32)
    alpha_acc = state.alpha
    alpha_cand = (state.alpha if cfg.persistent_alpha
                  else torch.ones_like(state.alpha))
    converged = torch.zeros(Bn, dtype=torch.bool, device=dev)
    max_it = cfg.sqp_max_iter

    # safety cap: alpha can be halved at most `halvings` times before it
    # reaches alpha_min, plus one accepting trip per SQP iteration and
    # slack for the bootstrap/straggler trips
    halvings = max(1, int(math.ceil(
        math.log(max(cfg.alpha_min, 1e-30))
        / math.log(min(max(cfg.beta_alpha, 1e-6), 0.999999)))))
    trip_cap = (cfg.sqp_max_iter * (1 if cfg.persistent_alpha else halvings)
                + halvings + 16)

    def body(carry, xra_p, x0s_p):
        (xa, us, dx_p, du_p, dphi_p, th_p, ph_p, md_p, mc_p), live, \
            (status, iters, conv_p, alpha_acc, alpha_cand,
             i_th, i_ph, i_dphi, i_md, i_mc, converged), trips = carry

        searching = live & (alpha_cand > cfg.alpha_min)
        dx_c, du_c, dphi_c, aux_c = _cand_at(
            xa, us, dx_p, du_p, alpha_cand, xra_p, x0s_p)
        th_c, ph_c, md_c, mc_c = aux_c

        ok = _accept(cfg, th_c, ph_c, alpha_cand, th_p, ph_p, dphi_p) \
            & searching
        reject = searching & ~ok
        alpha_next = torch.where(reject, cfg.beta_alpha * alpha_cand,
                                 alpha_cand)

        # --- acceptance: step, then freeze/continue transitions -------------
        m3 = ok[None, None, :]
        af = alpha_cand[None, None, :]
        xa2 = torch.where(m3, xa + af * dx_p, xa)
        us2 = torch.where(m3, us + af * du_p, us)
        alpha_acc2 = torch.where(ok, alpha_cand, alpha_acc)
        iters2 = iters + ok.to(i32)

        conv_c = (dphi_c > cfg.conv_dphi) & (th_c < cfg.conv_theta)
        nan_c = ~torch.isfinite(th_c + ph_c + dphi_c)

        succ = ok & conv_p
        maxed = ok & ~conv_p & (iters2 >= max_it)
        nanfr = ok & ~conv_p & (iters2 < max_it) & nan_c
        cont = ok & ~(succ | maxed | nanfr)

        # --- rejection bottoming out at alpha_min (or entering the loop
        # already at the floor) ------------------------------------------------
        stalled = (reject & (alpha_next <= cfg.alpha_min)) | (live & ~searching)
        succ2 = stalled & conv_p
        minstep = stalled & ~conv_p
        alpha_acc2 = torch.where(stalled, alpha_next, alpha_acc2)

        status2 = torch.where(
            succ | succ2, STATUS_SUCCESS,
            torch.where(nanfr, STATUS_NAN_DETECTED,
                        torch.where(minstep, STATUS_MIN_STEP, status))
        ).to(i32)
        iters3 = torch.where(nanfr | succ2, iters2 + 1,
                             torch.where(minstep, max_it, iters2)).to(i32)
        live2 = live & ~(succ | succ2 | maxed | nanfr | minstep)
        converged2 = converged | succ | succ2

        # --- info bookkeeping: acceptance-frozen scenarios report the
        # pre-step values; nan/stall-frozen ones the current pending values
        acc_info = succ | maxed | cont
        oth_info = nanfr | succ2 | minstep

        def wr(prev_val, pend_val, cand_val):
            return torch.where(acc_info, pend_val,
                               torch.where(oth_info, cand_val, prev_val))

        i_th2 = wr(i_th, th_p, torch.where(nanfr, th_c, th_p))
        i_ph2 = wr(i_ph, ph_p, torch.where(nanfr, ph_c, ph_p))
        i_dphi2 = wr(i_dphi, dphi_p, torch.where(nanfr, dphi_c, dphi_p))
        i_md2 = wr(i_md, md_p, torch.where(nanfr, md_c, md_p))
        i_mc2 = wr(i_mc, mc_p, torch.where(nanfr, mc_c, mc_p))

        # --- pending state: accepted scenarios adopt the candidate ----------
        up = cont | nanfr
        mp = up[None, None, :]
        dx_p2 = torch.where(mp, dx_c, dx_p)
        du_p2 = torch.where(mp, du_c, du_p)
        th_p2 = torch.where(up, th_c, th_p)
        ph_p2 = torch.where(up, ph_c, ph_p)
        dphi_p2 = torch.where(up, dphi_c, dphi_p)
        md_p2 = torch.where(up, md_c, md_p)
        mc_p2 = torch.where(up, mc_c, mc_p)
        conv_p2 = torch.where(cont, conv_c, conv_p)

        alpha_cand2 = torch.where(
            ok, alpha_cand if cfg.persistent_alpha
            else torch.ones_like(alpha_cand), alpha_next)

        return ((xa2, us2, dx_p2, du_p2, dphi_p2, th_p2, ph_p2, md_p2, mc_p2),
                live2,
                (status2, iters3, conv_p2, alpha_acc2, alpha_cand2,
                 i_th2, i_ph2, i_dphi2, i_md2, i_mc2, converged2),
                trips + 1)

    def run_phase(carry, xra_p, x0s_p, thresh):
        # one host sync per trip: the live count decides whether to go on
        width = carry[1].shape[0]
        while carry[3] < trip_cap:
            with span("readback"):
                n_live = int(carry[1].sum())
            if n_live <= thresh:
                break
            with span("trip", width):
                carry = body(carry, xra_p, x0s_p)
        return carry

    def take_carry(carry, idx):
        S, live, Bk, trips = carry
        return (tuple(_take(a, idx) for a in S), _take(live, idx),
                tuple(_take(a, idx) for a in Bk), trips)

    def scatter_carry(dst, src, idx):
        # dx_p/du_p (S[2], S[3]) are not scattered back: a frozen lane's
        # pending direction is never read after the loop
        S_d, live_d, Bk_d, _ = dst
        S_s, live_s, Bk_s, trips_s = src
        S_o = tuple(d if i in (2, 3) else _put(d, c, idx)
                    for i, (d, c) in enumerate(zip(S_d, S_s)))
        return (S_o, _put(live_d, live_s, idx),
                tuple(_put(d, c, idx) for d, c in zip(Bk_d, Bk_s)), trips_s)

    carry = ((xa0, us0, dx_p, du_p, dphi_p, th_p, ph_p, md_p, mc_p), live,
             (status, iters, conv_p, alpha_acc, alpha_cand,
              th_p, ph_p, dphi_p, md_p, mc_p, converged),
             0)
    carry = run_phase(carry, xra, x0s, thresh=tiers[0] if tiers else 0)
    if tiers:
        # compacted phases: gather the carry once per tier crossing, run the
        # same loop at the smaller width, scatter back innermost first
        stack = []
        xra_p, x0s_p = xra, x0s
        for i, Bc in enumerate(tiers):
            live_o = carry[1]
            # stable: live lanes first in their original order; then re-sort
            # the selected prefix, since the permutes need a strictly
            # increasing index list (which dead pad lanes fill it is moot)
            order = torch.argsort((~live_o).to(torch.int32), stable=True)
            idx = torch.sort(order[:Bc]).values
            stack.append((carry, idx))
            with span("compact", Bc):
                carry = take_carry(carry, idx)
                xra_p = (_xra_at(Bc) if shared_ref
                         else permute.take_lanes(xra_p, idx))
                x0s_p = permute.take_lanes(x0s_p, idx)
            nxt = tiers[i + 1] if i + 1 < len(tiers) else 0
            carry = run_phase(carry, xra_p, x0s_p, thresh=nxt)
        for outer, idx in reversed(stack):
            with span("compact", idx.shape[0]):
                carry = scatter_carry(outer, carry, idx)

    (xa_f, us_f, *_), _, \
        (status_f, iters_f, _, alpha_f, alpha_cand_f,
         f_th, f_ph, f_dphi, f_md, f_mc, converged_f), trips_f = carry

    # live scenarios that hit the trip cap and any residual RUNNING-at-
    # alpha-floor cases report the stall distinctly
    stalled = (status_f == STATUS_RUNNING) & (alpha_cand_f <= cfg.alpha_min)
    status_f = torch.where(stalled, STATUS_MIN_STEP, status_f).to(i32)
    info = NmpcInfo(
        converged=converged_f, sqp_iters=iters_f,
        theta=f_th, phi=f_ph, dphi=f_dphi, alpha=alpha_f,
        max_defect=f_md, min_constraint=f_mc, status=status_f,
        ls_trips=torch.full((Bn,), 1 + trips_f, dtype=i32, device=dev),
    )
    state_f = NmpcState(x=xa_f.permute(2, 0, 1).contiguous(),
                        u=us_f.permute(2, 0, 1).contiguous(), alpha=alpha_f)
    return state_f, info


def shift_state(state: NmpcState, steps: int = 1) -> NmpcState:
    """Receding-horizon warm start: shift the trajectories ``steps`` stages
    forward, repeating the terminal entries; alpha resets to 1."""
    x = torch.cat([state.x[..., steps:, :],
                   state.x[..., -1:, :].repeat_interleave(steps, dim=-2)],
                  dim=-2)
    u = torch.cat([state.u[..., steps:, :],
                   state.u[..., -1:, :].repeat_interleave(steps, dim=-2)],
                  dim=-2)
    return NmpcState(x=x, u=u, alpha=torch.ones_like(state.alpha))


def make_benchmark_problem(cfg: NmpcConfig, dtype=torch.float32,
                           device: DeviceLike = None):
    """The reference benchmark scenario: stance with a yaw / forward /
    height reference step. Returns (x0 [nx], x_ref [N+1, nx])."""
    dev = resolve_device(device)
    x0 = torch.zeros(srbd.NX, dtype=dtype, device=dev)
    x0[8] = 1.0
    x_ref_k = torch.zeros(srbd.NX, dtype=dtype, device=dev)
    x_ref_k[2] = 0.2
    x_ref_k[6] = 0.5
    x_ref_k[8] = 1.0
    x_ref = x_ref_k.expand(cfg.N + 1, srbd.NX).contiguous()
    return x0, x_ref
