"""The readers of the program's spans: on hand-built traces (a gap charged
by where it starts, a gap that opens outside the solve, widths read from
the names, nothing without a solve span), and in a traced CPU run of each
cell, where a traced batch is one ``srbd::solve`` span."""

import pytest
import torch

from gpu_bench import harness
from gpu_bench import trace as trace_mod
from gpu_bench.metrics import (host_syncs_per_batch, k1_trips_per_batch,
                               lane_use_pct, ls_trips_per_batch,
                               readback_idle_ms_per_batch)
from gpu_bench.trace import Trace


def _run(host, ops=(), iters=(), window_s=1.0):
    batches = [dict(n=4, iters=i, traced=True) for i in iters]
    return harness.Run(config={}, batches=batches,
                       trace=Trace(list(ops), list(host), window_s))


# two solves: the first reads back at 1.0-1.2 and 2.0-2.1, the second at
# 5.0-5.1; every span of a solve inside it
HOST = [("srbd::solve", 0.0, 4.0), ("srbd::trip[64]", 0.1, 0.9),
        ("srbd::readback", 1.0, 1.2), ("srbd::trip[16]", 1.3, 1.9),
        ("srbd::readback", 2.0, 2.1), ("aten::add", 2.2, 2.3),
        ("srbd::solve", 4.5, 6.0), ("srbd::trip[64]", 4.6, 4.9),
        ("srbd::readback", 5.0, 5.1),
        # outside every solve: not the program's batch
        ("srbd::readback", 7.0, 7.5), ("srbd::trip[64]", 7.6, 7.8)]


def test_counts_per_solve_span():
    run = _run(HOST, iters=[100, 20])
    assert host_syncs_per_batch.read(run) == 1.5
    assert k1_trips_per_batch.read(run) == 1.5
    assert ls_trips_per_batch.read(run) == 0.0
    # 120 iterations over 64 + 16 + 64 launched lanes
    assert lane_use_pct.read(run) == pytest.approx(100.0 * 120 / 144)


def test_lane_use_falls_back_to_the_synchronous_iterations():
    host = [("srbd::solve", 0.0, 4.0), ("srbd::sqp_iter[32]", 0.1, 1.0),
            ("srbd::ls_trip", 0.2, 0.3), ("srbd::ls_trip", 0.4, 0.5),
            ("srbd::sqp_iter[32]", 1.1, 2.0), ("srbd::ls_trip", 1.2, 1.3)]
    run = _run(host, iters=[48])
    assert ls_trips_per_batch.read(run) == 3.0
    assert k1_trips_per_batch.read(run) == 0.0
    assert lane_use_pct.read(run) == 75.0


def test_idle_is_charged_where_the_gap_starts():
    ops = [("k", 0.1, 1.1),      # runs dry inside the read at 1.0-1.2
           ("k", 1.5, 2.05),     # runs dry inside the read at 2.0-2.1
           ("k", 2.5, 3.0),      # dry at 3.0, outside any read
           ("k", 3.5, 4.6),      # dry at 4.6, inside the solve, no read
           ("k", 4.7, 5.05),     # dry inside the read at 5.0-5.1
           ("k", 5.3, 7.1),      # dry inside the read outside the solves
           ("k", 7.9, 8.0)]
    run = _run(HOST, ops=ops, iters=[1, 1], window_s=8.0)
    # gaps 1.1-1.5 (0.4 s), 2.05-2.5 (0.45 s), 5.05-5.3 (0.25 s), whole,
    # though each outlasts its read; 3.0-3.5 and 4.6-4.7 are no read's,
    # 7.1-7.9 opens outside every solve
    assert readback_idle_ms_per_batch.read(run) == pytest.approx(
        1e3 * (0.4 + 0.45 + 0.25) / 2)


def test_nothing_without_a_solve_span():
    host = [h for h in HOST if h[0] != "srbd::solve"]
    run = _run(host, ops=[("k", 0.0, 1.1), ("k", 1.5, 2.0)], iters=[5])
    for reader in (host_syncs_per_batch, readback_idle_ms_per_batch,
                   k1_trips_per_batch, ls_trips_per_batch, lane_use_pct):
        assert reader.read(run) is None
        assert reader.read(harness.Run(config={}, batches=[])) is None


def test_widths_are_read_from_the_names():
    assert host_syncs_per_batch.width("srbd::trip[131072]") == 131072
    assert host_syncs_per_batch.width("srbd::sqp_iter[4096]") == 4096


@pytest.mark.parametrize("name,counts", [
    ("fleet_cold", ("host_syncs_per_batch", "k1_trips_per_batch",
                    "lane_use_pct")),
    ("sync_cold", ("host_syncs_per_batch", "ls_trips_per_batch",
                   "lane_use_pct"))])
def test_traced_cpu_run_reads_one_solve_span_a_batch(monkeypatch, name,
                                                     counts):
    captured, traced = [], []
    capture = trace_mod.capture

    def keep(run_batches, cuda=True):
        captured.append(capture(run_batches, cuda))
        return captured[-1]

    def count(solve):
        def run(*a):
            traced.append(torch.autograd._profiler_enabled())
            return solve(*a)
        return run

    monkeypatch.setattr(trace_mod, "capture", keep)
    out = harness.run_cell(name, 2 ** 31 + 91, 0.0, True, device="cpu",
                           dtype=torch.float64, batch=64, keep=64,
                           wrap_solve=count)
    (cap,) = captured
    solves = host_syncs_per_batch.solve_spans(cap.read())
    assert len(solves) == sum(traced) >= 2
    for m in counts:
        assert out["metrics"][m]["value"] > 0
    # the CPU run traces no device: no idle to charge
    assert "readback_idle_ms_per_batch" not in out["metrics"]
