"""Lane gather / scatter by a sorted index list (kernel K2 of the port).

Counterpart of ``srbd_nmpc_tpu/ops/permute_pallas.py`` (``take_lanes``,
``set_lanes``). The engine's straggler-compaction crossings move the loop
carry into and out of each tier with these: ``idx`` is strictly increasing
(live lanes first, original order kept).

- ``take_lanes_ref`` / ``set_lanes_ref``: plain PyTorch versions.
- ``take_lanes`` / ``set_lanes``: CPU tensors go to the plain versions;
  CUDA tensors launch ``csrc/permute.cu`` (float32 only) or raise.

The TPU kernels' windowed one-hot matmul, its fallback and their width
rules are TPU workarounds and are not carried over: the CUDA kernel takes
any sorted unique ``idx`` and any widths. Both routes are bitwise.
"""

from __future__ import annotations

import ctypes

import torch

# CUDA threads per block of both K2 kernels
THREADS = 256

# launches of the CUDA kernels since the last reset (read by chip_smoke.py)
launches = {"take_lanes": 0, "set_lanes": 0}


def take_lanes_ref(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = a[..., idx[j]]``."""
    return a.index_select(-1, idx)


def set_lanes_ref(orig: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
                  ) -> torch.Tensor:
    """``out = orig; out[..., idx[p]] = src[..., p]``."""
    return orig.index_copy(orig.dim() - 1, idx, src)


def _lib():
    from srbd_nmpc_tpu_torch.utils.build import load_kernel

    lib = load_kernel("permute")
    if lib.srbd_take_lanes_launch.argtypes is None:
        lib.srbd_take_lanes_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        lib.srbd_take_lanes_launch.restype = ctypes.c_int
        lib.srbd_set_lanes_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        lib.srbd_set_lanes_launch.restype = ctypes.c_int
    return lib


def _cuda_index(idx: torch.Tensor, device: torch.device) -> torch.Tensor:
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if idx.device != device:
        raise ValueError(f"idx lies on {idx.device}, data on {device}")
    return idx.to(torch.int32).contiguous()


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA permute kernels take float32 CUDA "
                        f"tensors, got {t.dtype} on {t.device}")


def take_lanes(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather lanes ``idx`` (sorted, unique) of the last axis of ``a``."""
    if a.device.type == "cpu":
        return take_lanes_ref(a, idx)
    _check("a", a)
    idx32 = _cuda_index(idx, a.device)
    B, Bc = a.shape[-1], idx32.shape[0]
    a2 = a.contiguous()
    R = a2.numel() // B if B else 0
    out = torch.empty(a.shape[:-1] + (Bc,), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().srbd_take_lanes_launch(a2.data_ptr(), idx32.data_ptr(),
                                        out.data_ptr(), R, B, Bc, THREADS,
                                        stream)
    if err != 0:
        raise RuntimeError(f"take_lanes kernel launch failed: CUDA error {err}")
    launches["take_lanes"] += 1
    return out


def set_lanes(orig: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """``orig`` with lanes ``idx`` (sorted, unique) replaced by ``src``."""
    if orig.device.type == "cpu":
        return set_lanes_ref(orig, src, idx)
    _check("orig", orig)
    _check("src", src)
    idx32 = _cuda_index(idx, orig.device)
    B, Bc = orig.shape[-1], idx32.shape[0]
    if tuple(src.shape) != tuple(orig.shape[:-1]) + (Bc,):
        raise ValueError(f"src shape {tuple(src.shape)} does not match "
                         f"orig {tuple(orig.shape)} with {Bc} lanes")
    o2, s2 = orig.contiguous(), src.contiguous()
    R = o2.numel() // B if B else 0
    out = torch.empty_like(o2)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    err = _lib().srbd_set_lanes_launch(o2.data_ptr(), s2.data_ptr(),
                                       idx32.data_ptr(), out.data_ptr(),
                                       R, B, Bc, THREADS, stream)
    if err != 0:
        raise RuntimeError(f"set_lanes kernel launch failed: CUDA error {err}")
    launches["set_lanes"] += 1
    return out
