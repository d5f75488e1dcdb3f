"""PyTorch port of the iteration-synchronous batched solve
(``engine._solve_batched_soa``) vs the JAX engine, f64, on each QP route:
``fused`` with ``speculative=False`` (K1 at alpha = 0, K7a line search),
``pallas`` (K5, K6, K7a), ``xla`` (plain), and ``"auto"`` with
``refine=1`` (the ``xla`` route with iterative refinement). The JAX Pallas
kernels run in interpret mode; each JAX reference solve runs once per
module.

Tolerances: the same converged set, ``sqp_iters``, ``status`` and
``ls_trips``; u at rtol 1e-9 and x at rtol 1e-9 (atol 1e-11), and the
merit diagnostics at rtol 1e-8."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch.models import merit_kernel, srbd, srbd_linearize
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.ops import riccati_kernel, sqp_planes
from srbd_nmpc_tpu_torch.parallel import sharded

torch.set_num_threads(1)
F64 = torch.float64
B, N = 8, 5
Q_DIAG = [0] * 11 + [10]
QF_DIAG = [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100]
BASE = dict(N=N, sqp_max_iter=8, pallas_block=8)
ROUTES = {
    "fused": dict(qp_kernel="fused", speculative=False),
    "pallas": dict(qp_kernel="pallas"),
    "xla": dict(qp_kernel="xla"),
    "auto_refine1": dict(qp_kernel="auto", refine=1),
}


def _x0s():
    rng = np.random.default_rng(21)
    scales = np.array([0.002, 0.002, 0.002, 0.05, 0.05, 0.2, 0.5, 0.5])
    x0 = np.zeros(12)
    x0[8] = 1.0
    return x0[None] + scales[:, None] * rng.normal(size=(B, 12))


def _port_problem(**kw):
    cfg = engine.NmpcConfig(**{**BASE, **kw})
    params = srbd.SRBDParams.create(dt=0.015, dtype=F64, device="cpu")
    weights = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, N, F64,
                                         device="cpu")
    _, x_ref = engine.make_benchmark_problem(cfg, F64, device="cpu")
    states = engine.NmpcState(
        x=torch.zeros((B, N + 1, 12), dtype=F64),
        u=torch.full((B, N, 12), 100.0, dtype=F64),
        alpha=torch.ones(B, dtype=F64))
    return params, weights, cfg, states, torch.as_tensor(_x0s()), x_ref


def _jax_problem(**kw):
    dtype = jnp.float64
    cfg = jengine.NmpcConfig(**{**BASE, **kw})
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=dtype)
    weights = jengine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, N, dtype)
    _, x_ref = jengine.make_benchmark_problem(cfg, dtype)
    states = jengine.NmpcState(x=jnp.zeros((B, N + 1, 12), dtype),
                               u=jnp.full((B, N, 12), 100.0, dtype),
                               alpha=jnp.ones(B, dtype))
    return params, weights, cfg, states, jnp.asarray(_x0s()), x_ref


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route_solves(request):
    kw = ROUTES[request.param]
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        ref = jengine.solve(*_jax_problem(**kw))
    finally:
        pl.pallas_call = orig
    return request.param, ref, sharded.solve_batch(*_port_problem(**kw))


def test_route_matches_jax(route_solves):
    route, (st_j, info_j), (st, info, summ) = route_solves
    np.testing.assert_allclose(st.u.numpy(), np.asarray(st_j.u), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_j.x), rtol=1e-9,
                               atol=1e-11)
    for name in ("converged", "sqp_iters", "status", "ls_trips"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(info_j, name)),
                                      err_msg=name)
    for name in ("theta", "phi", "dphi", "alpha", "max_defect",
                 "min_constraint"):
        np.testing.assert_allclose(getattr(info, name).numpy(),
                                   np.asarray(getattr(info_j, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    # the batch has a straggler tail and converged scenarios
    assert int(info.sqp_iters.max()) > int(info.sqp_iters.min())
    assert int(summ.n_converged) >= B // 2


def test_routes_run_on_cpu_without_launching_kernels():
    counts = lambda: (dict(sqp_planes.launches),  # noqa: E731
                      srbd_linearize.launches,
                      dict(merit_kernel.launches),
                      dict(riccati_kernel.launches))
    before = counts()
    for kw in ROUTES.values():
        engine.solve(*_port_problem(**kw))
    assert counts() == before


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kernel_constants_built_once_per_solve_for_the_route(route):
    """The constants the engine builds once per solve: None on the CPU and
    on the plain routes; for a CUDA device the blocks of the kernels the
    route runs, each equal to the block its wrapper builds without them:
    K1's and K3's and K7a's on ``fused``, K5's and K7a's on ``pallas``;
    K7a's only where the loop runs it (not the speculative loop's). Only
    the device's type decides, so the CPU parameters serve here."""
    params, weights, cfg = _port_problem(**ROUTES[route])[:3]
    assert engine._kernel_constants(params, weights, cfg, "cpu") is None
    kc = engine._kernel_constants(params, weights, cfg, "cuda")
    if route not in ("fused", "pallas"):
        assert kc is None
        return
    Ac, bc = srbd.constraint_matrix(params)
    assert torch.equal(kc.Ac, Ac) and torch.equal(kc.bc, bc)
    assert torch.equal(kc.merit, merit_kernel.kernel_constants(
        params, weights.Q, weights.Qf, weights.R, Ac, bc))
    if route == "pallas":
        assert kc.fused is None
        assert torch.equal(kc.linearize, srbd_linearize.kernel_constants(
            params, weights.Q, weights.R, Ac, bc))
    else:
        assert kc.linearize is None and kc.fused is not None
    spec = engine._kernel_constants(params, weights, cfg, "cuda", merit=False)
    assert spec.merit is None
    assert spec.fused is not None or spec.linearize is not None


def test_speculative_matches_synchronous():
    """The speculative loop reproduces the synchronous fused loop (it
    evaluates the same candidates with the same acceptance rule), as
    tests/test_sqp_pallas.py::test_engine_speculative_matches_synchronous
    holds the JAX engine; sqp_max_iter=6 so some scenarios exhaust it."""
    prob = list(_port_problem(qp_kernel="fused", sqp_max_iter=6))
    cfg = prob[2]
    prob[2] = dataclasses.replace(cfg, speculative=True)
    st_s, info_s = engine.solve(*prob)
    prob[2] = dataclasses.replace(cfg, speculative=False)
    st_y, info_y = engine.solve(*prob)
    np.testing.assert_allclose(st_s.u.numpy(), st_y.u.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(st_s.x.numpy(), st_y.x.numpy(), rtol=1e-10,
                               atol=1e-12)
    for name in ("converged", "status", "sqp_iters"):
        assert torch.equal(getattr(info_s, name), getattr(info_y, name)), name
    np.testing.assert_allclose(st_s.alpha.numpy(), st_y.alpha.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(info_s.theta.numpy(), info_y.theta.numpy(),
                               rtol=1e-9)


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_sqp_step_matches_jax(route):
    """One batched SQP iteration from the cold start (``engine.sqp_step``);
    the kernel route and the plain one (the solves above cover the rest)."""
    kw = ROUTES[route]
    params, weights, cfg, states, x0s, x_ref = _port_problem(**kw)
    st, info = engine.sqp_step(params, weights, cfg, states, x0s, x_ref)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        st_j, info_j = jengine.sqp_step(*_jax_problem(**kw))
    finally:
        pl.pallas_call = orig
    np.testing.assert_allclose(st.u.numpy(), np.asarray(st_j.u), rtol=1e-9,
                               atol=1e-9)
    for name in ("converged", "status", "ls_trips", "sqp_iters"):
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(info_j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(info.dphi.numpy(), np.asarray(info_j.dphi),
                               rtol=1e-8)
