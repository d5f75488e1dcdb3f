"""The float64 cell ``f64_cold`` and the readers it adds: on the CPU at a
small batch in the configuration's own float64 the program is correct
under the cell's limits; the FP64 roofline reproduces its recorded bound;
K2's milliseconds are read per solve span where the program marks its
compactions, and nothing where it does not."""

import pytest
import torch

from gpu_bench import harness, roofline
from gpu_bench.metrics import (k1_f64_roofline, k2_permute_ms_per_batch,
                               step_mfu, step_mfu_f64)
from gpu_bench.trace import Trace


def test_f64_cold_is_correct_on_the_cpu():
    c = harness.cell("f64_cold")
    assert c["config"]["dtype"] == "float64" and c["config"]["route"] == {}
    out = harness.run_cell("f64_cold", 2 ** 31 + 19, 0.0, False,
                           device="cpu", batch=64, keep=64)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 64
    for name in ("u_gap", "x_gap"):
        assert out["checks"][name]["value"] < out["checks"][name]["limit"]


def test_fp64_bound_and_share():
    lanes = 131072
    ms = 1e3 * k1_f64_roofline.bound_s(
        k1_f64_roofline.OPS_PER_LANE * lanes,
        k1_f64_roofline.BYTES_PER_LANE * lanes)
    # K1's bound at B=131072 against 34 TFLOP/s: by operations
    assert round(ms, 3) == 1.229
    assert k1_f64_roofline.BYTES_PER_LANE == 13968
    ops = [("k1s_planes_f64_kernel", 0.0, 0.002),
           ("k1s_riccati_team_f64_kernel", 0.002, 0.010),
           ("at::native::where", 0.010, 0.011)]
    run = harness.Run(config={}, batches=[dict(iters=lanes, traced=True)],
                      trace=Trace(ops, [], 0.02))
    assert k1_f64_roofline.read(run) == pytest.approx(100 * ms / 10.0)
    assert step_mfu_f64.read(run) == pytest.approx(
        step_mfu.read(run) * roofline.PEAK_FP32 / k1_f64_roofline.PEAK_FP64)
    assert k1_f64_roofline.read(harness.Run(config={}, batches=[])) is None


HOST = [("srbd::solve", 0.0, 4.0), ("srbd::compact[65536]", 0.5, 0.6),
        ("srbd::compact[65536]", 3.0, 3.1), ("srbd::solve", 5.0, 9.0),
        ("srbd::compact[65536]", 5.5, 5.6)]
OPS = [("void take_lanes_kernel<long, true>(...)", 0.50, 0.51),
       ("void take_lanes8_kernel<long, true>(...)", 5.50, 5.52),
       ("void set_lanes_kernel<long, true>(...)", 3.00, 3.03),
       ("k1s_planes_kernel", 1.0, 2.0)]


def test_k2_ms_per_solve_span():
    run = harness.Run(config={}, batches=[], trace=Trace(OPS, HOST, 9.0))
    assert k2_permute_ms_per_batch.read(run) == pytest.approx(
        1e3 * (0.01 + 0.02 + 0.03) / 2)


def test_k2_reads_nothing_without_compact_spans():
    host = [h for h in HOST if not h[0].startswith("srbd::compact")]
    for trace in (Trace(OPS, host, 9.0), None):
        run = harness.Run(config={}, batches=[], trace=trace)
        assert k2_permute_ms_per_batch.read(run) is None


def test_f32_program_reads_above_the_f64_limits_on_the_cpu():
    """The control of the cell's limits, at the CPU's small batch: the same
    cell with the program in float32 fails ``u_gap`` or ``x_gap``."""
    out = harness.run_cell("f64_cold", 2 ** 31 + 19, 0.0, False,
                           device="cpu", batch=64, keep=64,
                           dtype=torch.float32)
    assert not out["correct"]
    assert any(out["checks"][k]["value"] > out["checks"][k]["limit"]
               for k in ("u_gap", "x_gap"))
