"""The reader ``k1b_ms_per_batch``: K1s-B's device milliseconds per solve
span, over its float32 and float64 forms."""

import pytest

from gpu_bench import harness
from gpu_bench.metrics import k1b_ms_per_batch
from gpu_bench.trace import Trace

HOST = [("srbd::solve", 0.0, 4.0), ("srbd::solve", 5.0, 9.0)]
OPS = [("k1s_planes_kernel(float const*, ...)", 1.0, 1.2),
       ("k1s_riccati_team_kernel(float const*, ...)", 1.2, 2.0),
       ("k1s_rollout_kernel(float const*, ...)", 2.0, 2.1),
       ("k1s_riccati_factor_kernel(float const*, ...)", 2.2, 2.9),
       ("k1s_riccati_rank6_kernel(float const*, ...)", 3.0, 3.5),
       ("riccati_team_kernel<true>(float const*, ...)", 3.5, 3.9),
       ("k1s_riccati_team_f64_kernel(double const*, ...)", 6.0, 7.5)]


def test_k1b_ms_per_solve_span():
    """Both forms of the gains team kernel count; its factor and rank-6
    forms, K6's team kernel and K1's other launches do not."""
    run = harness.Run(config={}, batches=[], trace=Trace(OPS, HOST, 9.0))
    assert k1b_ms_per_batch.read(run) == pytest.approx(1e3 * (0.8 + 1.5) / 2)


def test_k1b_reads_zero_without_the_kernel_and_none_without_a_solve():
    """A trace whose solves launch no K1s-B (the synchronous route) reads 0;
    a trace without solve spans, or no trace, None."""
    other = [o for o in OPS if "k1s_riccati_team" not in o[0]]
    run = harness.Run(config={}, batches=[], trace=Trace(other, HOST, 9.0))
    assert k1b_ms_per_batch.read(run) == 0.0
    for trace in (Trace(OPS, [], 9.0), None):
        run = harness.Run(config={}, batches=[], trace=trace)
        assert k1b_ms_per_batch.read(run) is None
