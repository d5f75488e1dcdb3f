"""SRBD dynamics in batch-last ("SoA") layout.

Counterpart of ``srbd_nmpc_tpu/models/srbd_soa.py``: vectors are
``[d, ...]`` and matrices ``[d, e, ...]`` with any number of trailing batch
axes. The formulas and their evaluation order are the JAX module's (its
SO(3) chain, Jacobian blocks, four-call RK4 and Euler sensitivities,
reference ``SRBD_model.cpp:75-181``); the CUDA kernels K5
(``csrc/linearize.cu``) and K7 (``csrc/merit.cu``) follow the same order.
Sums over the three components of an angle are written out left to right.
"""

from __future__ import annotations

from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models.srbd import GRAVITY, NX, SRBDParams
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.so3 import _theta_min


def _safe_theta(r: torch.Tensor) -> torch.Tensor:
    h = _theta_min(r.dtype)
    sq = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]
    return torch.sqrt(torch.clamp_min(sq, h * h))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[3, ...] -> [3, 3, ...] cross-product matrix."""
    v0, v1, v2 = v[0], v[1], v[2]
    z = torch.zeros_like(v0)
    return torch.stack([
        torch.stack([z, -v2, v1]),
        torch.stack([v2, z, -v0]),
        torch.stack([-v1, v0, z]),
    ])


def _g_vec(nb, dtype, device) -> torch.Tensor:
    """Gravity vector [3, *nb]."""
    return torch.cat([torch.zeros((2,) + nb, dtype=dtype, device=device),
                      torch.full((1,) + nb, GRAVITY, dtype=dtype,
                                 device=device)])


def _eye3(batch_like: torch.Tensor) -> torch.Tensor:
    """3x3 identity broadcastable against [3, 3, *batch_like.shape]."""
    return torch.eye(3, dtype=batch_like.dtype, device=batch_like.device
                     ).reshape((3, 3) + (1,) * batch_like.dim())


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0])


def so3_chain(r: torch.Tensor):
    """R (expm), Jl, Jlt (inverse left Jacobian) and djlt [3,3,3,...]
    (axis 0 = d/dr_a), sharing subexpressions (orientation_tool.h:76-227)."""
    t = _safe_theta(r)
    st, ct = torch.sin(t), torch.cos(t)
    t2 = t * t
    t3 = t2 * t
    inv_t = 1.0 / t
    W = skew(r)
    WW = sm.mm(W, W)
    I = _eye3(r[0])

    sinc = st * inv_t
    R = I + sinc * W + ((1.0 - ct) / t2) * WW

    V = W * inv_t
    VV = WW * (inv_t * inv_t)
    Jl = sinc * I + (1.0 - sinc) * (VV + I) + ((1.0 - ct) * inv_t) * V
    half_t = 0.5 * t
    hc = half_t * (torch.cos(half_t) / torch.sin(half_t))
    Jlt = hc * I + (1.0 - hc) * (VV + I) - half_t * V

    base = ((t * st + 2.0 * (ct - 1.0)) / t3) * V + (
        -(2.0 * t - 3.0 * st + t * ct) / t3) * VV
    c1 = (t - st) / t3
    c2 = (1.0 - ct) / t2

    e3 = torch.eye(3, dtype=r.dtype, device=r.device)
    nb = (1,) * (r.dim() - 1)
    E = [skew(e3[a].reshape((3,) + nb).expand(r.shape)) for a in range(3)]
    djl = [c1 * (sm.mm(E[a], W) + sm.mm(W, E[a])) + c2 * E[a] + r[a] * base
           for a in range(3)]
    djlt = torch.stack([-sm.mm(Jlt, sm.mm(djl[a], Jlt)) for a in range(3)])
    return dict(R=R, Jl=Jl, Jlt=Jlt, djlt=djlt)


def _iinv(params: SRBDParams, r: torch.Tensor) -> torch.Tensor:
    nb = (1,) * (r.dim() - 1)
    return params.inertia_inv.to(r.dtype).reshape((3, 3) + nb).expand(
        (3, 3) + r.shape[1:])


def _feet(params: SRBDParams, x: torch.Tensor):
    nb = (1,) * (x.dim() - 1)
    ft = params.foot_pos.to(x.dtype)
    return (ft[0].reshape((3,) + nb).expand((3,) + x.shape[1:]),
            ft[1].reshape((3,) + nb).expand((3,) + x.shape[1:]))


def dynamics(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
             ) -> torch.Tensor:
    """dx/dt: x [12, ...], u [12, ...] -> [12, ...] (SRBD_model.cpp:87-99)."""
    r, l, p, v = x[0:3], x[3:6], x[6:9], x[9:12]
    t = _safe_theta(r)
    st, ct = torch.sin(t), torch.cos(t)
    inv_t = 1.0 / t
    W = skew(r)
    WW = sm.mm(W, W)
    I = _eye3(r[0])
    sinc = st * inv_t
    R = I + sinc * W + ((1.0 - ct) * inv_t * inv_t) * WW
    VV = WW * (inv_t * inv_t)
    half_t = 0.5 * t
    hc = half_t * (torch.cos(half_t) / torch.sin(half_t))
    Jlt = hc * I + (1.0 - hc) * (VV + I) - half_t * (W * inv_t)

    RIRt = sm.mm(sm.mm(R, _iinv(params, r)), sm.transpose(R))
    w = sm.mv(RIRt, l)
    r_dot = sm.mv(Jlt, w)

    pf0, pf1 = _feet(params, x)
    l_dot = u[3:6] + u[9:12] + cross(pf0 - p, u[0:3]) + cross(pf1 - p, u[6:9])
    v_dot = (u[0:3] + u[6:9]) / params.mass.to(x.dtype) + _g_vec(
        (1,) * (x.dim() - 1), x.dtype, x.device)
    return torch.cat([r_dot, l_dot, v, v_dot], dim=0)


def jacobian_blocks(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """The five nonzero 3x3 blocks (D1, D2, SF, Sr, Sl) of the SRBD
    Jacobians (SRBD_model.cpp:105-140):

        J_fx = [[D1, D2, 0, 0],    J_fu = [[0,  0, 0,  0],
                [0,  0, SF, 0],            [Sr, I, Sl, I],
                [0,  0, 0,  I],            [0,  0, 0,  0],
                [0,  0, 0,  0]]            [I/m,0, I/m,0]]"""
    r, l, p = x[0:3], x[3:6], x[6:9]
    ch = so3_chain(r)
    R, Jl, Jlt, djlt = ch["R"], ch["Jl"], ch["Jlt"], ch["djlt"]

    RIRt = sm.mm(sm.mm(R, _iinv(params, r)), sm.transpose(R))
    w = sm.mv(RIRt, l)
    djlt_w = torch.stack([sm.mv(djlt[a], w) for a in range(3)], dim=1)

    D1 = djlt_w + sm.mm(sm.mm(Jlt, sm.mm(RIRt, skew(l)) - skew(w)), Jl)
    D2 = sm.mm(Jlt, RIRt)
    SF = skew(u[0:3] + u[6:9])
    pf0, pf1 = _feet(params, x)
    return D1, D2, SF, skew(pf0 - p), skew(pf1 - p)


def jacobians(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J_fx, J_fu) [12, 12, ...] (SRBD_model.cpp:105-140)."""
    D1, D2, SF, Sr, Sl = jacobian_blocks(params, x, u)
    Z = torch.zeros_like(D1)
    I = _eye3(x[0]).expand(D1.shape)

    def grid(rows):
        return torch.cat([torch.cat(row, dim=1) for row in rows], dim=0)

    J_fx = grid([[D1, D2, Z, Z], [Z, Z, SF, Z], [Z, Z, Z, I], [Z, Z, Z, Z]])
    Im = I / params.mass.to(x.dtype)
    J_fu = grid([[Z, Z, Z, Z], [Sr, I, Sl, I], [Z, Z, Z, Z], [Im, Z, Im, Z]])
    return J_fx, J_fu


def rk4(params: SRBDParams, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RK4 step from four ``dynamics`` calls (SRBD_model.cpp:174-179)."""
    dt = params.dt.to(x.dtype)
    k1 = dynamics(params, x, u)
    k2 = dynamics(params, x + 0.5 * dt * k1, u)
    k3 = dynamics(params, x + 0.5 * dt * k2, u)
    k4 = dynamics(params, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def euler_AB(params: SRBDParams, x: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler sensitivities (A, B) = (I + dt J_fx, dt J_fu)
    (SRBD_model.cpp:180-181)."""
    J_fx, J_fu = jacobians(params, x, u)
    dt = params.dt.to(x.dtype)
    I12 = torch.eye(NX, dtype=x.dtype, device=x.device).reshape(
        (NX, NX) + (1,) * (x.dim() - 1))
    return I12 + dt * J_fx, dt * J_fu
