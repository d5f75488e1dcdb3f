"""Wall-clock timing / benchmark harness (counterpart of
``srbd_nmpc_tpu/utils/timing.py``).

PyTorch returns from a CUDA call before the device finishes, so on CUDA the
harness calls ``torch.cuda.synchronize()`` before every clock read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Milliseconds since ``start()``; synchronizes ``device`` first."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self._device = device
        self._t0 = time.perf_counter()

    def start(self) -> None:
        _sync(self._device)
        self._t0 = time.perf_counter()

    def get(self) -> float:
        _sync(self._device)
        return (time.perf_counter() - self._t0) * 1e3


@dataclasses.dataclass(frozen=True)
class BenchResult:
    reps: int
    avg_ms: float
    p50_ms: float
    p90_ms: float
    min_ms: float
    times_ms: List[float]

    def __str__(self) -> str:
        return (f"avg {self.avg_ms:.3f} ms | p50 {self.p50_ms:.3f} ms | "
                f"p90 {self.p90_ms:.3f} ms | min {self.min_ms:.3f} ms "
                f"({self.reps} reps)")


def benchmark(fn: Callable, *args, reps: int = 100, warmup: int = 2,
              device: Optional[torch.device] = None) -> BenchResult:
    """Time ``fn(*args)``; on a CUDA ``device`` each rep ends in a sync."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    arr = np.asarray(times)
    return BenchResult(
        reps=reps,
        avg_ms=float(arr.mean()),
        p50_ms=float(np.percentile(arr, 50)),
        p90_ms=float(np.percentile(arr, 90)),
        min_ms=float(arr.min()),
        times_ms=times,
    )
