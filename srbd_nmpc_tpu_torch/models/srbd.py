"""SRBD model constants, parameters and the friction-cone constraint rows.

Counterpart of ``srbd_nmpc_tpu/models/srbd.py:32-88, 213-257``. The
dynamics themselves are ported as stage-plane algebra in
``models.srbd_planes`` (the only form the main path runs).

State  x = [r (axis-angle, 3), l (angular momentum, 3), p (CoM, 3), v (3)]
Input  u = [F_right (3), tau_right (3), F_left (3), tau_left (3)]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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
