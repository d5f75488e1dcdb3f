"""The solver's spans (``utils/profiling.span``) on the CPU profiler, on the
speculative fused route and the synchronous ``pallas`` route: a profiled
solve is bitwise the unprofiled one; one ``srbd::solve`` span holds every
other span; the trip, SQP-iteration and line-search spans count what the
solve reports; every read-back of the solve is a ``srbd::readback`` span;
with no profiler a span is the shared no-op.

A cold batch of 64 at N=5 with wide initial-state noise, so that some
scenarios straggle: the speculative loop crosses into its tiers of 32 and
8 lanes, and statuses 0, 1 and 2 all occur."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.parallel import sharded
from srbd_nmpc_tpu_torch.utils import profiling

torch.set_num_threads(1)
F32 = torch.float32
B, N = 64, 5
Q_DIAG = [0] * 11 + [10]
QF_DIAG = [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100]
ROUTES = {
    "spec_fused": dict(),
    "sync_pallas": dict(speculative=False, qp_kernel="pallas"),
}


def _solve(cfg):
    params = srbd.SRBDParams.create(dt=0.015, dtype=F32, device="cpu")
    weights = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, N, F32,
                                        device="cpu")
    x0_nom, x_ref = engine.make_benchmark_problem(cfg, F32, device="cpu")
    gen = torch.Generator().manual_seed(7)
    x0 = x0_nom[None] + 0.2 * torch.randn((B, 12), generator=gen, dtype=F32)
    state = engine.NmpcState(x=torch.zeros((B, N + 1, 12), dtype=F32),
                             u=torch.full((B, N, 12), 100.0, dtype=F32),
                             alpha=torch.ones(B, dtype=F32))
    st, info, _ = sharded.solve_batch(params, weights, cfg, state, x0, x_ref)
    return st, info


@pytest.fixture(scope="module", params=sorted(ROUTES))
def solves(request):
    cfg = engine.NmpcConfig(N=N, pallas_block=8, **ROUTES[request.param])
    plain = _solve(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _solve(cfg)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return request.param, cfg, plain, traced, events


def _spans(events, name):
    full = f"srbd::{name}"
    return [e for e in events if e[0] == full or e[0].startswith(full + "[")]


def _width(name):
    return int(name[name.index("[") + 1:-1])


def _inside(e, outer):
    return outer[1] <= e[1] and e[2] <= outer[2]


def test_profiled_solve_is_bitwise_the_plain_one(solves):
    _, _, (st0, info0), (st1, info1), _ = solves
    for a, b in ((st0.x, st1.x), (st0.u, st1.u),
                 (info0.status, info1.status),
                 (info0.sqp_iters, info1.sqp_iters),
                 (info0.ls_trips, info1.ls_trips)):
        assert torch.equal(a, b)
    assert set(info1.status.tolist()) >= {0, 1}


def test_one_solve_span_holds_every_span(solves):
    events = solves[4]
    (solve,) = _spans(events, "solve")
    others = [e for e in events
              if e[0].startswith("srbd::") and e[0] != "srbd::solve"]
    assert others
    assert all(_inside(e, solve) for e in others)


def test_launch_spans_count_the_solve(solves):
    route, cfg, _, (_, info), events = solves
    trips, iters = _spans(events, "trip"), _spans(events, "sqp_iter")
    ls_trips = _spans(events, "ls_trip")
    if route == "spec_fused":
        # the bootstrap and every trip; NmpcInfo.ls_trips counts them
        assert len(trips) == int(info.ls_trips[0])
        tiers = {B // f for f in cfg.compact_tiers
                 if B // f >= cfg.pallas_block
                 and (B // f) % cfg.pallas_block == 0}
        widths = {_width(e[0]) for e in trips}
        assert widths <= {B} | tiers and len(widths) > 1
        assert not iters and not ls_trips
    else:
        # an active lane counts every iteration, so the longest solve's
        # count is the loop's
        assert len(iters) == int(info.sqp_iters.max())
        assert {_width(e[0]) for e in iters} == {B}
        assert len(ls_trips) == int(info.ls_trips[0])
        assert all(any(_inside(t, i) for i in iters) for t in ls_trips)
        assert not trips


def test_compact_spans_hold_each_tier_crossing(solves):
    """On the speculative route every tier crossing's gather into the tier
    and scatter back out of it is one ``srbd::compact[<width>]`` span at
    the tier's width, two a tier, holding the K2 calls (on the CPU their
    plain ``index_select`` / ``index_copy``) and no trip; the synchronous
    route compacts nothing."""
    route, cfg, _, _, events = solves
    compact = _spans(events, "compact")
    if route != "spec_fused":
        assert not compact
        return
    trips = _spans(events, "trip")
    tiers = sorted({_width(e[0]) for e in trips} - {B}, reverse=True)
    assert tiers
    assert [_width(e[0]) for e in compact] == tiers + tiers[::-1]
    for c in compact:
        assert not any(_inside(t, c) for t in trips)
        assert any(e[0] in ("aten::index_select", "aten::index_copy")
                   and _inside(e, c) for e in events)


def test_every_readback_of_the_solve_is_a_span(solves):
    events = solves[4]
    (solve,) = _spans(events, "solve")
    reads = _spans(events, "readback")
    scalars = [e for e in events if e[0] == "aten::_local_scalar_dense"
               and _inside(e, solve)]
    assert scalars
    assert all(any(_inside(s, r) for r in reads) for s in scalars)
    # and no span without its read
    assert all(any(_inside(s, r) for s in scalars) for r in reads)


def test_no_profiler_gives_the_shared_no_op():
    assert profiling.span("solve") is profiling.NO_SPAN
    assert profiling.span("trip", 8) is profiling.NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("solve") is not profiling.NO_SPAN
