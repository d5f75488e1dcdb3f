"""Skew and cross products in batch-last layout (counterpart of
``srbd_nmpc_tpu/models/srbd_soa.py:34-63``; the rest of that file is not
on the main path)."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[3, ...] -> [3, 3, ...] cross-product matrix."""
    v0, v1, v2 = v[0], v[1], v[2]
    z = torch.zeros_like(v0)
    return torch.stack([
        torch.stack([z, -v2, v1]),
        torch.stack([v2, z, -v0]),
        torch.stack([-v1, v0, z]),
    ])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0])
