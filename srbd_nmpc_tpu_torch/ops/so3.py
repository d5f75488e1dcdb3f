"""SO(3) / so(3) toolbox, batched over leading axes (counterpart of
``srbd_nmpc_tpu/ops/so3.py``).

``skew``/``unskew``, ``expm`` (Rodrigues), ``logm``, the left Jacobian
``jl`` and its inverse ``jl_inv``, their derivatives ``djl``/``djl_inv``
(stacked on a leading axis of size 3: d/dv_x, d/dv_y, d/dv_z) and the
elementary rotations ``rotx/roty/rotz``. Vectors are ``[..., 3]`` and
matrices ``[..., 3, 3]``; branches are ``torch.where`` selects and nothing
is written in place, so every function traces under ``torch.func``
(``jacfwd``, ``vmap``).

The reference clamps the rotation angle at 1e-10 in double precision; in
f32 that would make theta^2 underflow, so the clamp is dtype-aware. Below
the clamp every coefficient already equals its theta -> 0 limit to within
the dtype's epsilon.
"""

from __future__ import annotations

import math

import torch

_THETA_MIN_F64 = 1e-10
_THETA_MIN_F32 = 1e-4


def _theta_min(dtype: torch.dtype) -> float:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _THETA_MIN_F64 if itemsize >= 8 else _THETA_MIN_F32


def _safe_theta(v: torch.Tensor) -> torch.Tensor:
    """Rotation angle ``max(|v|, theta_min)`` over the trailing axis; the
    squared norm is clamped before the sqrt."""
    h = _theta_min(v.dtype)
    sq = torch.sum(v * v, dim=-1)
    return torch.sqrt(torch.clamp_min(sq, h * h))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]; inverse of ``skew`` for antisymmetric input."""
    return torch.stack([-m[..., 1, 2], m[..., 0, 2], -m[..., 0, 1]], dim=-1)


def _eye_like(v: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (3, 3))


def expm(v: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3): ``I + sin(t)/t V + (1 - cos t)/t^2 V V``, V = skew(v)."""
    t = _safe_theta(v)[..., None, None]
    V = skew(v)
    VV = V @ V
    return (_eye_like(v) + (torch.sin(t) / t) * V
            + ((1.0 - torch.cos(t)) / (t * t)) * VV)


def logm(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3), branchless: 0 at trace +3, the dominant column's
    axis at trace -1 (angle pi), ``t/(2 sin t) unskew(R - R')`` otherwise."""
    dtype = R.dtype
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    h = _theta_min(dtype)

    # the acos argument is kept strictly inside (-1, 1), so the generic
    # branch stays finite; the degenerate branches are selected after
    tr_c = torch.clamp(tr, -1.0 + 1e-12, 1.0 - 1e-12)
    theta = torch.arccos(tr_c)
    coef = theta / (2.0 * torch.sin(theta))
    generic = coef[..., None] * unskew(R - R.mT)

    def _axis(col: int) -> torch.Tensor:
        d = 1.0 + R[..., col, col]
        d_safe = torch.clamp_min(d, 1e-24)
        scale = 1.0 / torch.sqrt(2.0 * d_safe)
        vec = torch.stack([R[..., i, col] + 1.0 if i == col else R[..., i, col]
                           for i in range(3)], dim=-1)
        return scale[..., None] * vec

    use_z = torch.abs(1.0 + R[..., 2, 2]) > h
    use_y = torch.abs(1.0 + R[..., 1, 1]) > h
    pi_axis = torch.where(use_z[..., None], _axis(2),
                          torch.where(use_y[..., None], _axis(1), _axis(0)))
    pi_branch = math.pi * pi_axis

    out = torch.where((tr <= -1.0)[..., None], pi_branch, generic)
    return torch.where((tr >= 1.0)[..., None], torch.zeros_like(out), out)


def jl(v: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3), with the normalised V = skew(v)/t."""
    t = _safe_theta(v)[..., None, None]
    V = skew(v) / t
    VV = V @ V
    I = _eye_like(v)
    s = torch.sin(t) / t
    return s * I + (1.0 - s) * (VV + I) + ((1.0 - torch.cos(t)) / t) * V


def jl_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse of the left Jacobian."""
    t = _safe_theta(v)[..., None, None]
    V = skew(v) / t
    VV = V @ V
    I = _eye_like(v)
    half_t_cot = 0.5 * t / torch.tan(0.5 * t)
    return half_t_cot * I + (1.0 - half_t_cot) * (VV + I) - (0.5 * t) * V


def _basis_skews(dtype, device) -> torch.Tensor:
    return skew(torch.eye(3, dtype=dtype, device=device))  # [3, 3, 3]


def djl(v: torch.Tensor) -> torch.Tensor:
    """d(jl)/dv stacked: out[..., a, :, :] = d jl(v) / d v_a, in closed form:
    (t - sin t)/t^3 (E_a W + W E_a) + (1 - cos t)/t^2 E_a
    + v_a [(t sin t + 2(cos t - 1))/t^3 V - (2t - 3 sin t + t cos t)/t^3 V V]
    with W = skew(v), V = W/t and E_a the basis skews."""
    t = _safe_theta(v)[..., None, None]
    W = skew(v)
    V = W / t
    VV = V @ V
    s, c = torch.sin(t), torch.cos(t)
    t2, t3 = t * t, t * t * t

    base = ((t * s + 2.0 * (c - 1.0)) / t3) * V + (
        -(2.0 * t - 3.0 * s + t * c) / t3) * VV

    E = _basis_skews(v.dtype, v.device)
    Wb = W[..., None, :, :]
    anti = E @ Wb + Wb @ E
    coef1 = ((t - s) / t3)[..., None, :, :]
    coef2 = ((1.0 - c) / t2)[..., None, :, :]
    per_axis = coef1 * anti + coef2 * E
    return per_axis + v[..., :, None, None] * base[..., None, :, :]


def djl_inv(v: torch.Tensor) -> torch.Tensor:
    """d(jl_inv)/dv stacked on the axis before the matrix: -Jlt djl_a Jlt."""
    Jinv = jl_inv(v)[..., None, :, :]
    return -(Jinv @ djl(v) @ Jinv)


def _rot(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotx(a: torch.Tensor) -> torch.Tensor:
    """Rotation about x."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def roty(a: torch.Tensor) -> torch.Tensor:
    """Rotation about y."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def rotz(a: torch.Tensor) -> torch.Tensor:
    """Rotation about z."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _rot([[c, -s, z], [s, c, z], [z, z, o]])
