"""The reader ``k1a_f64_ms_per_batch``: K1s-A f64's device milliseconds
per solve span, over every launch of its float64 plane pass."""

import pytest

from gpu_bench import harness
from gpu_bench.metrics import k1a_f64_ms_per_batch
from gpu_bench.trace import Trace

HOST = [("srbd::solve", 0.0, 4.0), ("srbd::solve", 5.0, 9.0)]
OPS = [("k1s_planes_f64_kernel(double const*, ...)", 1.0, 1.5),
       ("k1s_planes_f64_cost_kernel(double const*, ...)", 1.5, 1.7),
       ("k1s_riccati_team_f64_kernel(double const*, ...)", 1.7, 2.7),
       ("k1s_planes_kernel(float const*, ...)", 3.0, 3.2),
       ("k1s_planes_f64_kernel(double const*, ...)", 6.0, 6.25)]


def test_k1a_f64_ms_per_solve_span():
    """Every kernel named ``k1s_planes_f64*`` counts (the float64 plane pass
    in one launch or several); the float32 plane pass and K1s-B f64 do
    not; a float32 trace reads 0, a trace without solve spans None."""
    run = harness.Run(config={}, batches=[], trace=Trace(OPS, HOST, 9.0))
    assert k1a_f64_ms_per_batch.read(run) == pytest.approx(
        1e3 * (0.5 + 0.2 + 0.25) / 2)
    f32 = [o for o in OPS if "f64" not in o[0]]
    run = harness.Run(config={}, batches=[], trace=Trace(f32, HOST, 9.0))
    assert k1a_f64_ms_per_batch.read(run) == 0.0
    for trace in (Trace(OPS, [], 9.0), None):
        run = harness.Run(config={}, batches=[], trace=trace)
        assert k1a_f64_ms_per_batch.read(run) is None
