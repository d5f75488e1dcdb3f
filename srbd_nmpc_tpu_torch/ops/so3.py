"""SO(3) small-angle clamp (counterpart of ``srbd_nmpc_tpu/ops/so3.py:31-49``).

The reference clamps the rotation angle at 1e-10 in double precision; in
f32 that would make theta^2 underflow, so the clamp is dtype-aware. Below
the clamp every coefficient already equals its theta -> 0 limit to within
the dtype's epsilon.
"""

from __future__ import annotations

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
