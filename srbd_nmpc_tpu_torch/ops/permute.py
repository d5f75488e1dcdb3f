"""Lane gather / scatter by a sorted index list (kernel K2 of the port).

Counterpart of ``srbd_nmpc_tpu/ops/permute_pallas.py`` (``take_lanes``,
``set_lanes``). The engine's straggler-compaction crossings move the loop
carry into and out of each tier with these: ``idx`` is strictly increasing
(live lanes first, original order kept).

- ``take_lanes_ref`` / ``set_lanes_ref``: plain PyTorch versions.
- ``take_lanes`` / ``set_lanes``: CPU tensors go to the plain versions;
  CUDA tensors launch ``csrc/permute.cu`` (float32 data, or float64 data
  through its 8-byte form; an int32 or int64 ``idx`` as the caller holds
  it) or raise. One call is one device kernel.

The TPU kernels' windowed one-hot matmul, its fallback and their width
rules are TPU workarounds and are not carried over: the CUDA kernels take
any sorted unique ``idx`` and any widths. Both routes are bitwise.
"""

from __future__ import annotations

import ctypes

import torch

# CUDA threads per block of both K2 kernels (at most the kernels' launch
# bound, k2::MAX_THREADS) and output lanes per thread (k2::LANES)
THREADS = 256
LANES = 4
# blocks per SM the row chunks aim at, so that every tier fills the card
BLOCKS_PER_SM = 8
# gridDim.y limit
MAX_ROW_BLOCKS = 65535

# launches of the CUDA kernels since the last reset (read by chip_smoke.py)
launches = {"take_lanes": 0, "set_lanes": 0}


def take_lanes_ref(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = a[..., idx[j]]``."""
    return a.index_select(-1, idx)


def set_lanes_ref(orig: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
                  ) -> torch.Tensor:
    """``out = orig; out[..., idx[p]] = src[..., p]`` (``index_copy``
    takes an int64 ``idx`` only)."""
    return orig.index_copy(orig.dim() - 1, idx.long(), src)


def rows_per_block(R: int, lanes: int, sms: int, threads: int = THREADS) -> int:
    """Rows each block walks, for ``R`` rows of ``lanes`` output lanes: as
    many as leave about ``BLOCKS_PER_SM`` blocks per SM (at least 1, and
    few enough blocks along the rows for the grid's y limit)."""
    nx = -(-lanes // (LANES * threads))
    rpb = -(-R * nx // (BLOCKS_PER_SM * sms))
    return max(1, rpb, -(-R // MAX_ROW_BLOCKS))


# the launch entries of csrc/permute.cu by element size in bytes, (take,
# set) each, bound at first use
_fns = None


def _lib(elem_bytes: int):
    global _fns
    if _fns is None:
        from srbd_nmpc_tpu_torch.utils.build import load_kernel

        lib = load_kernel("permute")
        _fns = {}
        for size, tag in ((4, ""), (8, "8")):
            take = getattr(lib, f"srbd_take_lanes{tag}_launch")
            put = getattr(lib, f"srbd_set_lanes{tag}_launch")
            take.argtypes = ([ctypes.c_void_p] * 2
                             + [ctypes.c_int, ctypes.c_void_p]
                             + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_void_p])
            put.argtypes = ([ctypes.c_void_p] * 3
                            + [ctypes.c_int, ctypes.c_void_p]
                            + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p])
            take.restype = put.restype = ctypes.c_int
            _fns[size] = (take, put)
    return _fns[elem_bytes]


def _cuda_index(idx: torch.Tensor, dev: int) -> None:
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if not idx.is_cuda or idx.get_device() != dev:
        raise ValueError(f"idx lies on {idx.device}, data on cuda:{dev}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA permute kernels take float32 or "
                        f"float64 CUDA tensors, got {t.dtype} on {t.device}")


_sms = {}   # SMs of each card by device index


def _launch_args(dev: int, R: int, lanes: int):
    """(rows per block, threads, raw current stream) of a launch on card
    ``dev``. The host's time is most of a call at the small tiers, so
    this reads the raw stream pointer instead of building a
    ``torch.cuda.Stream`` object on every call."""
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return (rows_per_block(R, lanes, sms), THREADS,
            torch._C._cuda_getCurrentRawStream(dev))


def take_lanes(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather lanes ``idx`` (sorted, unique) of the last axis of ``a``."""
    if a.is_cpu:
        return take_lanes_ref(a, idx)
    _check("a", a)
    dev = a.get_device()
    _cuda_index(idx, dev)
    B, Bc = a.shape[-1], idx.shape[0]
    if Bc > B:
        raise ValueError(f"{Bc} unique lanes cannot come from {B}")
    a2 = a.contiguous()
    R = a2.numel() // B if B else 0
    out = a2.new_empty(a.shape[:-1] + (Bc,))
    if R * Bc == 0:
        return out
    vec = Bc % LANES == 0 and out.data_ptr() % 16 == 0
    rpb, threads, stream = _launch_args(dev, R, Bc)
    err = _lib(a2.element_size())[0](
        a2.data_ptr(), idx.data_ptr(), idx.element_size(), out.data_ptr(),
        R, B, Bc, rpb, int(vec), threads, stream)
    if err != 0:
        raise RuntimeError(f"take_lanes kernel launch failed: CUDA error {err}")
    launches["take_lanes"] += 1
    return out


def set_lanes(orig: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
              ) -> torch.Tensor:
    """``orig`` with lanes ``idx`` (sorted, unique) replaced by ``src``."""
    if orig.is_cpu:
        return set_lanes_ref(orig, src, idx)
    _check("orig", orig)
    _check("src", src)
    if src.dtype != orig.dtype:
        raise TypeError(f"src is {src.dtype}, orig {orig.dtype}")
    dev = orig.get_device()
    _cuda_index(idx, dev)
    B, Bc = orig.shape[-1], idx.shape[0]
    if src.shape[:-1] != orig.shape[:-1] or src.shape[-1] != Bc:
        raise ValueError(f"src shape {tuple(src.shape)} does not match "
                         f"orig {tuple(orig.shape)} with {Bc} lanes")
    if Bc > B:
        raise ValueError(f"{Bc} unique lanes cannot go to {B}")
    o2, s2 = orig.contiguous(), src.contiguous()
    R = o2.numel() // B if B else 0
    out = torch.empty_like(o2)
    if R * B == 0:
        return out
    vec = (B % LANES == 0 and o2.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    rpb, threads, stream = _launch_args(dev, R, B)
    err = _lib(o2.element_size())[1](
        o2.data_ptr(), s2.data_ptr(), idx.data_ptr(), idx.element_size(),
        out.data_ptr(), R, B, Bc, rpb, int(vec), threads, stream)
    if err != 0:
        raise RuntimeError(f"set_lanes kernel launch failed: CUDA error {err}")
    launches["set_lanes"] += 1
    return out
