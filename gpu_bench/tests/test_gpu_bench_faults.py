"""A run's check against planted faults and the control, on the CPU at a
small batch in float64: the unbroken program is correct; a solve that
returns its starting state, one that leaves half the batch unsolved, one
whose answer is altered where it is produced, and the control (the
reference in float32 with TF32 products in the program's place) are not.

The run is the harness's own (``harness.run_cell``) past its look for a
card; only the program's solve is wrapped."""

import pytest
import torch

from gpu_bench import check, harness
from gpu_bench.system import Answer

B = 96
# the warm mix in a cell of the default route
WARM_SPEC = harness.benchmark_spec()
WARM_SPEC["workloads"].append(dict(
    name="fleet_warm", config="srbd_n20_fleet", traffic="warm", chips=1,
    why="the receding-horizon cycle of the default route"))


def _unchanged(solve):
    def run(x, u, alpha, x0):
        a = solve(x, u, alpha, x0)
        return Answer(x=x, u=u, alpha=alpha, status=a.status,
                      sqp_iters=a.sqp_iters, converged=a.converged)
    return run


def _half(solve):
    def run(x, u, alpha, x0):
        h = x.shape[0] // 2
        a = solve(x[:h], u[:h], alpha[:h], x0[:h])
        ones = torch.ones(x.shape[0] - h, dtype=torch.int32)
        return Answer(x=torch.cat([a.x, x[h:]]), u=torch.cat([a.u, u[h:]]),
                      alpha=alpha, status=torch.cat([a.status, 0 * ones]),
                      sqp_iters=torch.cat([a.sqp_iters, ones]),
                      converged=torch.cat([a.converged, ones.bool()]))
    return run


def _altered(solve):
    def run(x, u, alpha, x0):
        a = solve(x, u, alpha, x0)
        u_bad = a.u.clone()
        u_bad[:, 0, 2] += 1.0
        return Answer(x=a.x, u=u_bad, alpha=a.alpha, status=a.status,
                      sqp_iters=a.sqp_iters, converged=a.converged)
    return run


def _run(name, **kw):
    kw.setdefault("dtype", torch.float64)
    return harness.run_cell(name, 2 ** 31 + 77, 0.0, False, device="cpu",
                            batch=B, keep=B, **kw)


@pytest.mark.parametrize("name", ["fleet_cold", "sync_cold"])
def test_unbroken_program_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == B


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_planted_fault_is_not_correct(fault):
    out = _run("fleet_cold", wrap_solve=fault)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    cfg = harness.load_config("srbd_n20_fleet")
    out = _run("fleet_cold", dtype=torch.float32,
               wrap_solve=check.control(cfg, "cpu"), warmup=False)
    assert not out["correct"], out["checks"]


def test_warm_mix_runs_and_checks():
    """The warm mix (``traffic/warm.json``, cell ``fleet_warm``) is data
    alone: set-up solves the fleet cold, each batch starts from that
    solution shifted a stage; the reference starts each sampled scenario
    from the program's own set-up solution there, and the set-up itself is
    checked against the reference's cold solve of it (``setup_*``)."""
    out = _run("fleet_warm", spec=WARM_SPEC)
    assert out["correct"], out["checks"]
    assert {"setup_mismatch_pct", "setup_u_gap", "setup_x_gap"} \
        <= set(out["checks"])
    bad = _run("fleet_warm", spec=WARM_SPEC, wrap_solve=_altered)
    assert not bad["correct"], bad["checks"]
