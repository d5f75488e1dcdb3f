"""Single-rigid-body-dynamics (SRBD) model: constants, parameters, the
friction-cone constraint rows, and the dynamics in "AoS" layout (vectors
``[..., 12]``, batched over leading axes) with the exact sensitivities of
their RK4 map.

Counterpart of ``srbd_nmpc_tpu/models/srbd.py``. This layout serves the
exact sensitivities, which ``torch.func`` differentiates per scenario and
stage; the solves run the same model in batch-last layout
(``models.srbd_soa``, ``models.srbd_planes``).

State  x = [r (axis-angle, 3), l (angular momentum, 3), p (CoM, 3), v (3)]
Input  u = [F_right (3), tau_right (3), F_left (3), tau_left (3)]

Continuous dynamics (SRBD_model.cpp:75-99):
    r_dot = Jl(r)^-1 w          with w = R I^-1 R' l,  R = expm(r)
    l_dot = tau_r + tau_l + (p_fr - p) x F_r + (p_fl - p) x F_l
    p_dot = v
    v_dot = (F_r + F_l)/m + g
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.ops import so3
from srbd_nmpc_tpu_torch.utils.device import DeviceLike, resolve_device

NX = 12  # state dim
NU = 12  # input dim
NG = 24  # constraint rows
GRAVITY = -9.8  # m/s^2


@dataclasses.dataclass(frozen=True)
class SRBDParams:
    """Model parameters. ``inertia_inv`` is the body-frame inverse inertia."""

    mass: torch.Tensor          # []
    inertia_inv: torch.Tensor   # [3,3]
    foot_pos: torch.Tensor      # [2,3]  (right, left)
    foot_rot: torch.Tensor      # [2,3,3]
    dt: torch.Tensor            # []
    mu: torch.Tensor            # []  friction coefficient
    lfx: torch.Tensor           # []  foot half-length x
    lfz: torch.Tensor           # []  yaw lever
    fmax: torch.Tensor          # []  max normal force
    fmin: torch.Tensor          # []  min normal force

    @staticmethod
    def create(
        mass: float = 15.0,
        inertia_diag=(0.541667, 0.516667, 1.0416667),
        foot_right=(0.0, -0.1, 0.0),
        foot_left=(0.0, 0.1, 0.0),
        dt: float = 0.015,
        mu: float = 0.5,
        lfx: float = 0.05,
        lfz: float = 0.05,
        fmax: float = 1000.0,
        fmin: float = 0.0,
        dtype=torch.float32,
        device: DeviceLike = None,
    ) -> "SRBDParams":
        dev = resolve_device(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=dev)

        inertia = torch.diag(t(inertia_diag))
        return SRBDParams(
            mass=t(mass),
            inertia_inv=torch.linalg.inv(inertia),
            foot_pos=t([foot_right, foot_left]),
            foot_rot=torch.eye(3, dtype=dtype, device=dev).expand(2, 3, 3)
            .clone(),
            dt=t(dt), mu=t(mu), lfx=t(lfx), lfz=t(lfz),
            fmax=t(fmax), fmin=t(fmin),
        )


def constraint_matrix(params: SRBDParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Friction-cone / torque rows: feasible iff ``Ac @ u + bc >= 0``.

    Per leg, 12 rows over that leg's [F; tau] block: friction pyramid,
    normal-force bounds, ZMP and yaw torque limits, zero roll torque
    (a pair of opposing rows). ``Ac`` is leg-block-diagonal.
    """
    dtype, dev = params.foot_rot.dtype, params.foot_rot.device
    mu, lfx, lfz = params.mu, params.lfx, params.lfz
    e = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    Ac = torch.zeros((NG, NU), dtype=dtype, device=dev)
    for leg in range(2):
        R = params.foot_rot[leg]
        rx, ry, rz = R[:, 0], R[:, 1], R[:, 2]
        rows_F = torch.stack([
            -e[0] + mu * e[2], -e[1] + mu * e[2],
            e[0] + mu * e[2], e[1] + mu * e[2],
            -e[2], e[2],
            lfx * rz, lfx * rz, lfz * rz, lfz * rz,
            z3, z3,
        ])
        rows_tau = torch.stack([z3, z3, z3, z3, z3, z3,
                                -ry, ry, -rz, rz, -rx, rx])
        Ac[12 * leg:12 * leg + 12, 6 * leg:6 * leg + 6] = torch.cat(
            [rows_F, rows_tau], dim=1)
    bc = torch.zeros(NG, dtype=dtype, device=dev)
    bc[4] = params.fmax
    bc[5] = -params.fmin
    bc[16] = params.fmax
    bc[17] = -params.fmin
    return Ac, bc


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ vector on the trailing axes."""
    return torch.einsum("...ij,...j->...i", M, v)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _p(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.to(dtype=x.dtype, device=x.device)


def continuous_dynamics(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
                        ) -> torch.Tensor:
    """dx/dt = f(x, u), batched over leading axes (SRBD_model.cpp:87-99)."""
    r, l, p, v = x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12]
    R = so3.expm(r)
    RIRt = R @ _p(params.inertia_inv, x) @ R.mT
    w = _mv(RIRt, l)
    r_dot = _mv(so3.jl_inv(r), w)
    feet = _p(params.foot_pos, x)
    l_dot = (u[..., 3:6] + u[..., 9:12]
             + _cross(feet[0] - p, u[..., 0:3])
             + _cross(feet[1] - p, u[..., 6:9]))
    # gravity as a constant tensor: no in-place write, so torch.func traces it
    g = torch.tensor([0.0, 0.0, GRAVITY], dtype=x.dtype, device=x.device)
    v_dot = (u[..., 0:3] + u[..., 6:9]) / _p(params.mass, x) + g
    return torch.cat([r_dot, l_dot, v, v_dot], dim=-1)


def rk4_step(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
             ) -> torch.Tensor:
    """Classical RK4 step of the SRBD ODE over ``params.dt``, batched
    (SRBD_model.cpp:174-179)."""
    dt = _p(params.dt, x)
    k1 = continuous_dynamics(params, x, u)
    k2 = continuous_dynamics(params, x + 0.5 * dt * k1, u)
    k3 = continuous_dynamics(params, x + 0.5 * dt * k2, u)
    k4 = continuous_dynamics(params, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_jacobians(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sensitivities of the RK4 map, (A, B) = (d rk4 / dx, d rk4 / du)
    [..., 12, 12]: ``torch.func.jacfwd`` over ``rk4_step``, wrapped in
    ``torch.func.vmap`` once per leading axis (the JAX
    ``linearize_shooting``'s ``"exact"`` sensitivities)."""
    jac = torch.func.jacfwd(lambda xx, uu: rk4_step(params, xx, uu),
                            argnums=(0, 1))
    for _ in range(x.dim() - 1):
        jac = torch.func.vmap(jac)
    return jac(x, u)
