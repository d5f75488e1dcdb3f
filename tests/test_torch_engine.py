"""PyTorch port of the speculative batched solve vs the JAX engine (f64).

The configuration is the compaction one of
tests/test_sqp_planes.py::test_engine_compaction_is_bitwise_identical:
N=5, sqp_max_iter=12, pallas_block=2, B=32 with mixed perturbation scales,
so the tiers 16 and 4 engage and iteration counts differ per scenario.
The JAX reference solves (interpret mode) run once per module: the default
configuration, and ``park_factor=True`` (K1's factor-parking body) on the
speculative loop and on the synchronous ``fused`` route."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.ops import permute

torch.set_num_threads(1)
F64 = torch.float64
B = 32
Q_DIAG = [0] * 11 + [10]
QF_DIAG = [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100]


def _x0s():
    rng = np.random.default_rng(21)
    scales = np.concatenate([np.full(20, 0.002), np.full(6, 0.05),
                             np.full(4, 0.2), np.full(2, 0.5)])
    x0 = np.zeros(12)
    x0[8] = 1.0
    return x0[None] + scales[:, None] * rng.normal(size=(B, 12))


def _port_problem():
    cfg = engine.NmpcConfig(N=5, sqp_max_iter=12, pallas_block=2,
                            qp_kernel="fused")
    params = srbd.SRBDParams.create(dt=0.015, dtype=F64, device="cpu")
    weights = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, cfg.N, F64,
                                     device="cpu")
    _, x_ref = engine.make_benchmark_problem(cfg, F64, device="cpu")
    states = engine.NmpcState(
        x=torch.zeros((B, cfg.N + 1, 12), dtype=F64),
        u=torch.full((B, cfg.N, 12), 100.0, dtype=F64),
        alpha=torch.ones(B, dtype=F64))
    return params, weights, cfg, states, torch.as_tensor(_x0s()), x_ref


def _jax_solve(**kw):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        dtype = jnp.float64
        cfg = jengine.NmpcConfig(N=5, sqp_max_iter=12, pallas_block=2,
                                 qp_kernel="fused", **kw)
        params = jsrbd.SRBDParams.create(dt=0.015, dtype=dtype)
        weights = jengine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, cfg.N,
                                             dtype)
        _, x_ref = jengine.make_benchmark_problem(cfg, dtype)
        states = jengine.NmpcState(
            x=jnp.zeros((B, cfg.N + 1, 12), dtype),
            u=jnp.full((B, cfg.N, 12), 100.0, dtype),
            alpha=jnp.ones(B, dtype))
        st, info = jengine.solve(params, weights, cfg, states,
                                 jnp.asarray(_x0s()), x_ref)
        return st, info
    finally:
        pl.pallas_call = orig


@pytest.fixture(scope="module")
def jax_solve():
    return _jax_solve()


# park_factor=True on the two loops that run K1
FACTOR_LOOPS = {"spec": dict(park_factor=True),
                "sync": dict(park_factor=True, speculative=False)}


@pytest.fixture(scope="module", params=sorted(FACTOR_LOOPS))
def factor_solves(request):
    kw = FACTOR_LOOPS[request.param]
    params, weights, cfg, states, x0s, x_ref = _port_problem()
    port = engine.solve(params, weights, dataclasses.replace(cfg, **kw),
                        states, x0s, x_ref)
    return request.param, _jax_solve(**kw), port


@pytest.fixture(scope="module")
def port_solves():
    prob = _port_problem()
    params, weights, cfg, states, x0s, x_ref = prob
    out = {}
    for key, kw in {"compact": dict(compact=True),
                    "full": dict(compact=False),
                    "tiers28": dict(compact=True, compact_tiers=(2, 8))}.items():
        out[key] = engine.solve(params, weights, dataclasses.replace(cfg, **kw),
                                states, x0s, x_ref)
    return out


def _assert_same_solve(port, ref):
    (st, info), (st_j, info_j) = port, ref
    np.testing.assert_allclose(st.u.numpy(), np.asarray(st_j.u), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_j.x), rtol=1e-9,
                               atol=1e-11)
    for name in ("sqp_iters", "status", "converged", "ls_trips"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(info_j, name)))
    for name in ("theta", "phi", "dphi", "alpha", "max_defect",
                 "min_constraint"):
        np.testing.assert_allclose(getattr(info, name).numpy(),
                                   np.asarray(getattr(info_j, name)),
                                   rtol=1e-8, atol=1e-12)
    # the solve had a straggler tail for the tiers to compact
    assert int(info.sqp_iters.max()) > int(info.sqp_iters.min())


def test_solve_matches_jax(jax_solve, port_solves):
    _assert_same_solve(port_solves["compact"], jax_solve)


def test_park_factor_solve_matches_jax(factor_solves):
    """``park_factor=True`` (K1's factor-parking body) on the speculative
    loop and on the synchronous ``fused`` route against the JAX engine with
    the same flag."""
    _, ref, port = factor_solves
    _assert_same_solve(port, ref)


def test_park_factor_compaction_is_bitwise_identical(port_solves):
    """The factor body keeps compaction bitwise, and it solves the default
    body's problem (same iterations; u to rounding)."""
    params, weights, cfg, states, x0s, x_ref = _port_problem()
    cfg = dataclasses.replace(cfg, park_factor=True)
    st_c, info_c = engine.solve(params, weights, cfg, states, x0s, x_ref)
    st_f, info_f = engine.solve(params, weights,
                                dataclasses.replace(cfg, compact=False),
                                states, x0s, x_ref)
    assert torch.equal(st_c.u, st_f.u) and torch.equal(st_c.x, st_f.x)
    for name in ("sqp_iters", "status", "theta", "ls_trips"):
        assert torch.equal(getattr(info_c, name), getattr(info_f, name))
    st_g, info_g = port_solves["compact"]
    assert torch.equal(info_c.sqp_iters, info_g.sqp_iters)
    np.testing.assert_allclose(st_c.u.numpy(), st_g.u.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("speculative", [True, False])
def test_park_factor_has_no_effect_without_planes(speculative):
    """As in JAX, ``park_factor`` only picks K1's body: the dense route
    (``planes=False``) solves bitwise as without it, on both loops."""
    params, weights, cfg, states, x0s, x_ref = _port_problem()
    cfg = dataclasses.replace(cfg, planes=False, speculative=speculative)
    st, info = engine.solve(params, weights, cfg, states, x0s, x_ref)
    st_p, info_p = engine.solve(params, weights, dataclasses.replace(
        cfg, park_factor=True), states, x0s, x_ref)
    assert torch.equal(st.u, st_p.u) and torch.equal(st.x, st_p.x)
    for name in ("sqp_iters", "status", "theta", "ls_trips"):
        assert torch.equal(getattr(info, name), getattr(info_p, name))


def test_merit_fast_takes_the_plain_merit_for_float64(monkeypatch):
    """Under ``qp_kernel="auto"`` a float64 batch takes the plain merit
    (K7b is float32; JAX takes its plain merit off the TPU), a float32
    batch K7b's branch; ``"pallas"`` takes K7b's branch for both."""
    from srbd_nmpc_tpu_torch.models import merit_kernel

    params, weights, cfg, states, _, x_ref = _port_problem()
    calls = []
    k7b = merit_kernel.merit
    monkeypatch.setattr(merit_kernel, "merit",
                        lambda *a, **k: calls.append(1) or k7b(*a, **k))
    for qp_kernel, dtype, n in (("auto", F64, 0), ("auto", torch.float32, 1),
                                ("pallas", F64, 1)):
        del calls[:]
        c = dataclasses.replace(cfg, qp_kernel=qp_kernel)
        assert engine._pallas_eligible(c, B, dtype) == bool(n)
        out = engine._merit_fast(params, weights, c, states.x.to(dtype),
                                 states.u.to(dtype), x_ref, with_grad=True)
        assert len(calls) == n
        ref = engine.merit(params, weights, c, states.x, states.u, x_ref,
                           with_grad=True)
        np.testing.assert_allclose(out[1].double().numpy(), ref[1].numpy(),
                                   rtol=1e-5 if n and dtype != F64 else 1e-12)


def test_compaction_is_bitwise_identical(port_solves):
    st_c, info_c = port_solves["compact"]
    st_f, info_f = port_solves["full"]
    st_t, info_t = port_solves["tiers28"]
    for st, info in ((st_c, info_c), (st_t, info_t)):
        assert torch.equal(st.u, st_f.u)
        assert torch.equal(st.x, st_f.x)
        assert torch.equal(info.sqp_iters, info_f.sqp_iters)
        assert torch.equal(info.status, info_f.status)
        assert torch.equal(info.theta, info_f.theta)


def test_pretty_matches_jax(jax_solve):
    _, info_j = jax_solve
    info = engine.NmpcInfo(**{
        f.name: torch.as_tensor(np.array(getattr(info_j, f.name)))
        for f in dataclasses.fields(info_j)})
    assert info.pretty() == info_j.pretty()
    one_j = jengine.NmpcInfo(**{f.name: getattr(info_j, f.name)[0]
                                for f in dataclasses.fields(info_j)})
    one = engine.NmpcInfo(**{f.name: getattr(info, f.name)[0]
                             for f in dataclasses.fields(info)})
    assert one.pretty() == one_j.pretty()


def test_shift_state_and_benchmark_problem_match_jax():
    rng = np.random.default_rng(5)
    x, u = rng.normal(size=(3, 6, 12)), rng.normal(size=(3, 5, 12))
    a = rng.random(3)
    for steps in (1, 2):
        got = engine.shift_state(convert.state_from_numpy(
            x, u, a, F64, device="cpu"), steps)
        ref = jengine.shift_state(jengine.NmpcState(
            x=jnp.asarray(x), u=jnp.asarray(u), alpha=jnp.asarray(a)), steps)
        for name in ("x", "u", "alpha"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
    cfg = engine.NmpcConfig(N=7)
    x0, xr = engine.make_benchmark_problem(cfg, F64, device="cpu")
    x0_j, xr_j = jengine.make_benchmark_problem(jengine.NmpcConfig(N=7),
                                                jnp.float64)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(x0_j))
    np.testing.assert_array_equal(xr.numpy(), np.asarray(xr_j))


def test_weights_state_and_config_carry_across():
    w_j = jengine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, 9, jnp.float64)
    w = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, 9, F64, device="cpu")
    w_c = convert.weights_from_numpy(
        {f.name: np.asarray(getattr(w_j, f.name))
         for f in dataclasses.fields(w_j)}, dtype=F64, device="cpu")
    for name in ("Q", "R", "Qf"):
        np.testing.assert_array_equal(getattr(w, name).numpy(),
                                      np.asarray(getattr(w_j, name)))
        assert torch.equal(getattr(w, name), getattr(w_c, name))
    s_j = jengine.NmpcState.initial(4, jnp.float64)
    s = engine.NmpcState.initial(4, F64, device="cpu")
    for name in ("x", "u", "alpha"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(s_j, name)))

    cfg_j = jengine.NmpcConfig(N=7, compact_tiers=(4, 16), reg=1e-8)
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(cfg_j)}
    cfg = convert.config_from_jax_fields(fields)
    assert {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)} == fields
    assert engine.NmpcConfig() == convert.config_from_jax_fields(
        {f.name: getattr(jengine.NmpcConfig(), f.name)
         for f in dataclasses.fields(jengine.NmpcConfig)})
    with pytest.raises(KeyError, match="missing from the port"):
        convert.config_from_jax_fields({**fields, "new_knob": 1})
    with pytest.raises(ValueError, match="refine"):
        engine.NmpcConfig(qp_kernel="fused", refine=1)


def test_accept_matches_jax():
    rng = np.random.default_rng(6)
    n = 64
    vals = [10.0 ** rng.uniform(-12, -3, n), rng.normal(size=n),
            rng.random(n), 10.0 ** rng.uniform(-12, -3, n),
            rng.normal(size=n), rng.normal(size=n)]
    got = engine._accept(engine.NmpcConfig(),
                         *(torch.as_tensor(v) for v in vals))
    ref = jengine._accept(jengine.NmpcConfig(), *(jnp.asarray(v) for v in vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [
    dict(qp_kernel="pscan"), dict(rank4=True),
    dict(unbatched=True, qp_kernel="pscan"), dict(pscan_min_N=2),
    dict(unbatched=True, pscan_min_N=2),
])
def test_configurations_outside_the_slice_raise(kw):
    """Still outside the port: the associative-scan Riccati (batched and
    for one scenario, where the JAX unbatched step takes lqr_solve_pscan)
    and states of a rank other than 2 and 3."""
    params, weights, cfg, states, x0s, x_ref = _port_problem()
    kw = dict(kw)
    if kw.pop("unbatched", False):
        states = engine.NmpcState(x=states.x[0], u=states.u[0],
                                  alpha=states.alpha[0])
        x0s = x0s[0]
    if kw.pop("rank4", False):
        states = engine.NmpcState(x=states.x.reshape((4, 8) + states.x.shape[1:]),
                                  u=states.u.reshape((4, 8) + states.u.shape[1:]),
                                  alpha=states.alpha.reshape(4, 8))
        x0s = x0s.reshape(4, 8, 12)
    cfg = dataclasses.replace(cfg, **{"qp_kernel": "auto", **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        engine.solve(params, weights, cfg, states, x0s, x_ref)


@pytest.mark.parametrize("kw,passes", [
    (dict(), True), (dict(compact=False), True),
    (dict(qp_kernel="fused"), True),
    (dict(qp_kernel="pallas", speculative=False), False),
    (dict(qp_kernel="fused", speculative=False), False),
    (dict(planes=False), False), (dict(park_factor=True), False),
])
def test_float64_on_cuda_runs_the_speculative_fused_route_only(kw, passes):
    """A float64 batch on a CUDA device passes ``_check_slice`` on the
    speculative fused planes route (K1's gains body and K2, which have
    float64 forms) and raises on every other kernel route, naming the
    ROADMAP item "f64 kernels"; float32 passes everywhere, float16
    nowhere. The device is stubbed: the check reads only the state's rank,
    device type and dtype."""
    import types

    cfg = dataclasses.replace(engine.NmpcConfig(N=5), **kw)

    def state(dtype):
        x = types.SimpleNamespace(dim=lambda: 3, dtype=dtype,
                                  device=torch.device("cuda"))
        return types.SimpleNamespace(x=x)

    engine._check_slice(cfg, state(torch.float32))
    if passes:
        engine._check_slice(cfg, state(torch.float64))
    else:
        with pytest.raises(NotImplementedError,
                           match='ROADMAP.md "f64 kernels"'):
            engine._check_slice(cfg, state(torch.float64))
    with pytest.raises(NotImplementedError, match="f64 kernels"):
        engine._check_slice(cfg, state(torch.float16))


@pytest.mark.parametrize("tiers", [(2, 8, 8), (np.int64(2), 8)])
def test_compact_tiers_accept_numpy_ints_and_drop_duplicates(
        port_solves, monkeypatch, tiers):
    """``compact_tiers`` takes numpy integers, and a repeated width adds no
    tier crossing (as many lane gathers as with (2, 8)); both give the
    (2, 8) result, bitwise."""
    params, weights, cfg, states, x0s, x_ref = _port_problem()
    calls = []
    take = permute.take_lanes
    monkeypatch.setattr(permute, "take_lanes",
                        lambda a, idx: calls.append(1) or take(a, idx))

    def gathers(ts):
        del calls[:]
        out = engine.solve(params, weights, dataclasses.replace(
            cfg, compact_tiers=ts), states, x0s, x_ref)
        return out, len(calls)

    (st, info), n = gathers(tiers)
    _, n28 = gathers((2, 8))
    st_t, info_t = port_solves["tiers28"]
    assert n == n28 > 0
    assert torch.equal(st.u, st_t.u) and torch.equal(st.x, st_t.x)
    assert torch.equal(info.sqp_iters, info_t.sqp_iters)
    assert torch.equal(info.status, info_t.status)
    with pytest.raises(ValueError, match="compact_tiers"):
        engine.solve(params, weights, dataclasses.replace(
            cfg, compact_tiers=(2.0, 8)), states, x0s, x_ref)
