"""The device trace of a steady stretch of a run's window.

``torch.profiler`` traces a few batches, its window held open ``PAD_S`` on
either side (on the card's machine the profiler keeps only the kernel
records whose times fall inside its window, and those can sit a second
away from their launches). The trace stays in memory. ``Trace`` holds the
device operations' intervals and the host's operations on the thread that
launched them.
"""

from __future__ import annotations

import bisect
import time
from typing import List, Tuple

import torch

PAD_S = 3.0
# device operations that are PyTorch's own (elementwise, where, index,
# copy, cat, reductions, sorts) and the runtime's copies and fills: the
# SQP loop's bookkeeping around the program's kernels
LIBRARY_MARKS = ("at::native::", "at_cuda_detail::", "cub::", "Memcpy",
                 "Memset")


def _ns(e, what: str) -> int:
    return int(getattr(e, f"{what}_ns")()) if hasattr(e, f"{what}_ns") \
        else int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    """``ops``: the device operations (name, start s, end s), by start;
    ``host``: the launching thread's operations (name, start s, end s);
    ``window_s``: the traced batches' wall time on the host's clock;
    ``busy_s``: the union of the device operations' intervals."""

    def __init__(self, ops, host, window_s: float):
        self.ops: List[Tuple[str, float, float]] = sorted(ops,
                                                          key=lambda o: o[1])
        self.host = sorted(host, key=lambda o: o[1])
        self.window_s = window_s
        self.busy = self._union()
        self.busy_s = sum(e - s for s, e in self.busy)

    def _union(self):
        out = []
        for _, s, e in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def seconds(self, match) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name
        ``match(name)`` accepts."""
        sel = [e - s for n, s, e in self.ops if match(n)]
        return sum(sel), len(sel)

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The device's idle gaps between its first and last operation,
        summed by what the host was doing at each gap's middle: the
        innermost host operation there ("parent/child" for a runtime call),
        or "python" where none was running."""
        starts = [h[1] for h in self.host]
        by = {}
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in self.host[max(0, i - 64):i] if h[2] >= mid]
            inner.sort(key=lambda h: h[1])
            if not inner:
                name = "python"
            elif inner[-1][0].startswith("cuda") and len(inner) > 1:
                name = f"{inner[-2][0]}/{inner[-1][0]}"
            else:
                name = inner[-1][0]
            by[name] = by.get(name, 0.0) + (s1 - e0)
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]


class Captured:
    """A finished profile and the traced batches' wall time; ``read()``
    turns it into a ``Trace`` once the window has closed."""

    def __init__(self, prof, window_s: float):
        self.prof, self.window_s = prof, window_s

    def read(self) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        cpu = torch.autograd.DeviceType.CPU
        threads = {}
        for e in events:
            if e.device_type() == cpu:
                tid = e.start_thread_id()
                threads[tid] = threads.get(tid, 0) + 1
        main = max(threads, key=threads.get) if threads else None
        ops, host = [], []
        for e in events:
            s = _ns(e, "start") * 1e-9
            rec = (e.name(), s, s + _ns(e, "duration") * 1e-9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                ops.append(rec)
            elif e.start_thread_id() == main:
                host.append(rec)
        return Trace(ops, host, self.window_s)


def capture(run_batches, cuda: bool = True) -> Captured:
    """Profile ``run_batches()``, which returns the host seconds its batches
    took. ``cuda``: trace the card (the CPU tests trace the host alone)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PAD_S)
        window_s = run_batches()
        if cuda:
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    return Captured(prof, window_s)
