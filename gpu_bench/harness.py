"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the problem, the fleet size, the
program's route, the reference and the comparison's limits) and a traffic
mix (``traffic/<traffic>.json``, read by ``traffic.py``). Each per-layer
metric is read by ``metrics/<name>.py``. All three are found by name.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from gpu_bench import check, traffic
from gpu_bench.system import System

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# scenarios of each batch kept for the check, and how many of all those
# kept the check compares
KEEP_PER_BATCH = 1024
SAMPLE = 16384
# seconds of batches the traced run profiles
TRACE_SPAN_S = 1.0


def use_checkout_caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout, so
    that only a checkout's first run builds: the port's nvcc builds
    (whose directory the port fixes in code, so it is assigned here) and
    PyTorch's extension and Triton caches."""
    from srbd_nmpc_tpu_torch.utils import build

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    build.BUILD_DIR = os.path.join(CACHE, "kernels")


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader ``metrics/<name>.py``: its ``read(run)`` returns the
    metric, or None where the run holds nothing to read."""
    return importlib.import_module(f"gpu_bench.metrics.{name}")


def cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    spec = benchmark_spec() if spec is None else spec
    wl = {w["name"]: w for w in spec["workloads"]}[name]

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(workload=wl, config=load_config(wl["config"]),
                traffic=traffic.load(wl["traffic"]),
                end_to_end=[m for m in spec["end_to_end"] if here(m)],
                per_layer=[m for m in spec["per_layer"] if here(m)])


@dataclasses.dataclass
class Run:
    """What the metric readers read: the config, one record per batch of
    the window, and the trace of the traced stretch (or None)."""

    config: dict
    batches: List[dict]
    trace: object = None


class _Kept:
    """Scenarios kept from each batch for the check, moved to the host so
    that the device's memory stays as the program leaves it: their lanes
    in the fleet, their noise draws and what the program answered."""

    def __init__(self):
        self.parts = []

    def add(self, lanes, noise, ans):
        part = dict(noise=noise, x=ans.x, u=ans.u, status=ans.status,
                    iters=ans.sqp_iters)
        part = {k: v[lanes].cpu() for k, v in part.items()}
        part["lanes"] = lanes.cpu()
        self.parts.append(part)

    def sample(self, n: int, seed: int, device) -> Optional[dict]:
        if not self.parts:
            return None
        cat = {k: torch.cat([p[k] for p in self.parts])
               for k in self.parts[0]}
        total = cat["lanes"].shape[0]
        gen = torch.Generator().manual_seed(seed)
        pick = torch.randperm(total, generator=gen)[:min(n, total)]
        return {k: v[pick].to(device) for k, v in cat.items()}


def _counters(ans) -> torch.Tensor:
    """[converged, unconverged, failed, sum of SQP iterations] of a batch,
    on the device. Failed: NAN_DETECTED or a non-finite x or u; unconverged:
    MAX_ITER_REACHED or MIN_STEP_LENGTH_REACHED (the solver's answer)."""
    finite = (torch.isfinite(ans.x).flatten(1).all(1)
              & torch.isfinite(ans.u).flatten(1).all(1))
    failed = (ans.status == 3) | ~finite
    unconv = ((ans.status == 1) | (ans.status == 2)) & ~failed
    return torch.stack([ans.converged.sum(), unconv.sum(), failed.sum(),
                        ans.sqp_iters.to(torch.int64).sum()])


def _summary(ms: List[float]) -> dict:
    """Batch times of the window at a glance, and the means of its two
    halves (a drift within the window shows between them)."""
    h = max(1, len(ms) // 2)
    return dict(mean=float(np.mean(ms)), p50=float(np.median(ms)),
                min=min(ms), max=max(ms), first_half=float(np.mean(ms[:h])),
                second_half=float(np.mean(ms[h:] or ms)))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", dtype=None, batch: Optional[int] = None,
             spec: Optional[dict] = None, t_process: Optional[float] = None,
             wrap_solve: Optional[Callable] = None,
             keep: int = KEEP_PER_BATCH, warmup: bool = True) -> dict:
    """One run of cell ``name``. ``device``, ``dtype`` and ``batch``
    override the configuration's (the CPU tests run small, in float64);
    ``wrap_solve`` wraps the program's solve (the planted faults of the
    tests, the control of ``calibrate.py``), ``keep`` and ``warmup`` serve
    the control's single batch. Returns the result object that ``run.py``
    prints."""
    t0 = time.perf_counter() if t_process is None else t_process
    c = cell(name, spec)
    cfg, wl = c["config"], c["workload"]
    dev = torch.device(device)
    dtype = dtype or getattr(torch, cfg["dtype"])
    B = batch or cfg["fleet"]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t_entry = time.perf_counter()
    system = System(cfg, dev, dtype)
    solve = system.solve if wrap_solve is None else wrap_solve(system.solve)
    tr = traffic.Traffic(c["traffic"], cfg, B, seed, dev, dtype)
    tr.setup(solve)
    kept = _Kept()
    lane_gen = torch.Generator(device=dev)
    lane_gen.manual_seed(int(seed) + 1)
    keep = min(keep, B)

    # set-up ends with one batch at the window's shapes
    t_warm = time.perf_counter()
    if warmup:
        solve(*tr.start(tr.draw()))
    sync()
    gc.collect()
    setup_parts = dict(to_entry=t_entry - t0, system=t_warm - t_entry,
                       warmup=time.perf_counter() - t_warm)

    records, failed_batches = [], 0

    def one_batch(traced=False):
        nonlocal failed_batches
        noise = tr.draw()
        t = time.perf_counter()
        try:
            ans = solve(*tr.start(noise))
            cnt = _counters(ans)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            kept.add(torch.randint(B, (keep,), generator=lane_gen,
                                   device=dev), noise, ans)
            cnt = cnt.tolist()
        except RuntimeError as exc:       # the batch gave no answer
            sync()
            ms = (time.perf_counter() - t) * 1e3
            failed_batches += 1
            cnt = [0, 0, B, 0]
            print(f"batch {len(records)} raised: {exc}", flush=True)
        records.append(dict(ms=ms, n=B, traced=traced, conv=cnt[0],
                            unconv=cnt[1], failed=cnt[2], iters=cnt[3]))

    setup_s = time.perf_counter() - t0
    trace_obj, traced_at, trace_s = None, None, 0.0
    t_w = time.perf_counter()
    # a window runs one batch at least; a traced run's lasts until its
    # stretch has been traced, and the stretch adds to its length
    while (not records or time.perf_counter() - t_w - trace_s < seconds
           or (trace and trace_obj is None)):
        if trace and trace_obj is None and len(records) >= 2:
            med = float(np.median([r["ms"] for r in records]))
            k = max(2, int(math.ceil(TRACE_SPAN_S * 1e3 / med)))

            def stretch():
                t1 = time.perf_counter()
                for _ in range(k):
                    one_batch(traced=True)
                return time.perf_counter() - t1

            from gpu_bench import trace as trace_mod
            traced_at = len(records)
            t1 = time.perf_counter()
            trace_obj = trace_mod.capture(stretch, cuda)
            trace_s = time.perf_counter() - t1
            continue
        one_batch()
    window_s = time.perf_counter() - t_w - trace_s

    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del solve, system
    sample = kept.sample(SAMPLE, int(seed) + 2, dev)
    kept = None
    tr.cold = tr.base = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = check.compare(cfg, tr, sample, dev, lost=failed_batches)
    check_s = time.perf_counter() - t_check
    attempted = sum(r["n"] for r in records)
    failed = sum(r["failed"] for r in records)
    if trace_obj is not None:
        trace_obj = trace_obj.read()
    run = Run(config=cfg, batches=records, trace=trace_obj)
    if trace:
        metrics = {}
        for m in c["per_layer"]:
            v = load_metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        ms = [r["ms"] for r in records]
        e2e = dict(
            converged_solves_per_s=sum(r["conv"] for r in records) / window_s,
            batch_ms_p90=float(np.percentile(ms, 90)),
            setup_s=setup_s)
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in c["end_to_end"]}
    out = dict(correct=check.correct(checks), attempted=attempted,
               failed=failed, metrics=metrics,
               device=dict(platform="gpu" if cuda else dev.type,
                           kind=(torch.cuda.get_device_name(dev) if cuda
                                 else dev.type),
                           count=1, memory_peak_bytes=mem_peak))
    if trace_obj is not None:
        out["device"].update(busy_s=trace_obj.busy_s,
                             window_s=trace_obj.window_s)
        out["breakdown"] = dict(device_ops=[list(x) for x in
                                            trace_obj.top_ops()],
                                idle_gaps=[list(x) for x in
                                           trace_obj.idle_gaps()])
    out["run"] = dict(workload=wl["name"], seed=seed, batches=len(records),
                      window_s=window_s, check_s=check_s,
                      setup_parts=setup_parts, batch_ms=_summary(
                          [r["ms"] for r in records]),
                      sample=0 if sample is None else len(sample["lanes"]),
                      traced_from_batch=traced_at)
    out["checks"] = checks
    return out
