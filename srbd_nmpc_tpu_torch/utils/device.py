"""Device resolution.

The port's entry points run on the CUDA card unless the caller asks for the
CPU (``device="cpu"``). Asking for a CUDA device, explicitly or by default,
where CUDA is unavailable raises: the port never falls back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``"cuda"``; ``"cuda"`` (or ``"cuda:i"``) requires a card,
    ``"cpu"`` is the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    return dev


def pin_float32(device: torch.device) -> None:
    """On CUDA, forbid TF32 in matmuls and convolutions: the convergence
    test ``theta < 1e-6`` must never see TF32 rounding (the JAX engine
    pins float32 matmul precision for the same reason)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
