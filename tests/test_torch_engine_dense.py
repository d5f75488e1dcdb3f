"""PyTorch port of the dense one-pass route (``NmpcConfig(planes=False)``)
vs the JAX engine, f64, on both loops: the speculative loop (bootstrap K3b,
then K3a trips, with compaction) and the synchronous ``fused`` loop (K3b,
then the K7a line search). The JAX Pallas kernels run in interpret mode;
each JAX reference solve runs once per module.

Configuration: B=8, N=12, pallas_block=4 (the speculative loop's B/2 tier
engages), x0 perturbed by s N(0, 1) with mixed scales s (as
tests/test_torch_engine_sync.py), sqp_max_iter=10 so the two widest
perturbations exhaust it while the rest converge.

Tolerances: the same converged set, ``sqp_iters``, ``status`` and
``ls_trips``; u at rtol 1e-9, x at rtol 1e-9 (atol 1e-11) and the merit
diagnostics at rtol 1e-8, as tests/test_torch_engine_sync.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch.models import merit_kernel, srbd
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.ops import permute, sqp_kernel, sqp_planes

torch.set_num_threads(1)
F64 = torch.float64
B, N = 8, 12
Q_DIAG = [0] * 11 + [10]
QF_DIAG = [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100]
BASE = dict(N=N, sqp_max_iter=10, pallas_block=4, qp_kernel="fused",
            planes=False)
SCALES = np.array([0.002, 0.002, 0.002, 0.05, 0.05, 0.2, 0.5, 0.5])
LOOPS = {"spec": dict(speculative=True), "sync": dict(speculative=False)}


def _x0s(scales=SCALES, seed=21):
    rng = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[8] = 1.0
    return x0[None] + scales[:, None] * rng.normal(size=(len(scales), 12))


def _port_problem(scales=SCALES, **kw):
    cfg = engine.NmpcConfig(**{**BASE, **kw})
    params = srbd.SRBDParams.create(dt=0.015, dtype=F64, device="cpu")
    weights = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, cfg.N, F64,
                                        device="cpu")
    _, x_ref = engine.make_benchmark_problem(cfg, F64, device="cpu")
    b = len(scales)
    states = engine.NmpcState(
        x=torch.zeros((b, cfg.N + 1, 12), dtype=F64),
        u=torch.full((b, cfg.N, 12), 100.0, dtype=F64),
        alpha=torch.ones(b, dtype=F64))
    return params, weights, cfg, states, torch.as_tensor(_x0s(scales)), x_ref


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


def _counts():
    return (dict(sqp_kernel.launches), dict(sqp_planes.launches),
            dict(merit_kernel.launches), dict(permute.launches))


@pytest.fixture(scope="module", params=sorted(LOOPS))
def loop_solves(request):
    kw = LOOPS[request.param]
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        ref = jengine.solve(*_jax_problem(**kw))
    finally:
        pl.pallas_call = orig
    before = _counts()
    port = engine.solve(*_port_problem(**kw))
    assert _counts() == before      # CPU tensors: no kernel launched
    return request.param, ref, port


def test_dense_route_matches_jax(loop_solves):
    loop, (st_j, info_j), (st, info) = loop_solves
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
    assert int(info.converged.sum()) >= B // 2


def test_dense_speculative_matches_synchronous():
    """The dense speculative loop reproduces the dense synchronous loop (the
    same candidates, the same acceptance rule), as
    tests/test_sqp_pallas.py::test_engine_speculative_matches_synchronous
    holds the JAX engine."""
    prob = list(_port_problem())
    cfg = prob[2]
    prob[2] = dataclasses.replace(cfg, speculative=True)
    st_s, info_s = engine.solve(*prob)
    prob[2] = dataclasses.replace(cfg, speculative=False)
    st_y, info_y = engine.solve(*prob)
    np.testing.assert_allclose(st_s.u.numpy(), st_y.u.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(st_s.x.numpy(), st_y.x.numpy(), rtol=1e-10,
                               atol=1e-12)
    for name in ("converged", "status"):
        assert torch.equal(getattr(info_s, name), getattr(info_y, name)), name
    np.testing.assert_allclose(st_s.alpha.numpy(), st_y.alpha.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(info_s.theta.numpy(), info_y.theta.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(info_s.dphi.numpy(), info_y.dphi.numpy(),
                               rtol=1e-9, atol=1e-12)


def test_dense_compaction_is_bitwise_identical():
    """The batch of tests/test_torch_engine.py (B=32, mixed perturbation
    scales, N=5, pallas_block=2: the tiers 16 and 4 engage); the compacted
    dense solve equals the full-width one."""
    scales = np.concatenate([np.full(20, 0.002), np.full(6, 0.05),
                             np.full(4, 0.2), np.full(2, 0.5)])
    prob = list(_port_problem(scales, N=5, sqp_max_iter=12, pallas_block=2))
    cfg = prob[2]
    out = {}
    for key, c in {"compact": dict(compact=True),
                   "full": dict(compact=False),
                   "tiers28": dict(compact=True, compact_tiers=(2, 8))}.items():
        prob[2] = dataclasses.replace(cfg, **c)
        out[key] = engine.solve(*prob)
    st_f, info_f = out["full"]
    assert int(info_f.sqp_iters.max()) > int(info_f.sqp_iters.min())
    for key in ("compact", "tiers28"):
        st, info = out[key]
        assert torch.equal(st.u, st_f.u) and torch.equal(st.x, st_f.x), key
        for name in ("sqp_iters", "status", "theta", "ls_trips"):
            assert torch.equal(getattr(info, name), getattr(info_f, name)), \
                (key, name)

