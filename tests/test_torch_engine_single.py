"""PyTorch port of the single-scenario NMPC solve (one robot, ``x [N+1, 12]``)
and of the merit entry points, vs the JAX engine, f64 on the CPU.

The reference problem (N=20, dt=0.015, the benchmark reference step, at
most 15 SQP iterations): the port must take the same SQP iterations,
status and line-search trips as JAX's ``engine.solve``, with u within 1e-8
(absolute; forces are ~100 N) and x within 1e-10; and meet the f64 C++
oracle (``native/srbd_oracle.cpp``) at the bars of
``tests/test_native_oracle.py`` (err_u / 100 < 1e-4, err_x < 1e-4; f32
with one refinement pass err_u / 100 < 1e-3). The merit functions are held
to JAX's at rtol 1e-12 (same formulas, sums in another order), the
linearization at 1e-11 absolute and the batched exact route at B=4 like the
solve. The port solves one scenario as a batch of one on the plain ``xla``
route, and is held to that bit for bit. Each JAX reference solve runs once
per module."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch.models import merit_kernel, srbd
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.utils.metrics import oracle_solve, parity_metric

torch.set_num_threads(1)
F64 = torch.float64
Q_DIAG = [0] * 11 + [10]
QF_DIAG = [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100]
CASES = {"default": dict(), "reset_alpha": dict(persistent_alpha=False),
         "exact": dict(sensitivity="exact", persistent_alpha=False)}
INFO_EXACT = ("sqp_iters", "status", "ls_trips", "converged")
INFO_CLOSE = ("theta", "phi", "dphi", "alpha", "max_defect", "min_constraint")


def _jax_setup(dtype=jnp.float64, N=20, **kw):
    cfg = jengine.NmpcConfig(N=N, sqp_max_iter=15, **kw)
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=dtype)
    weights = jengine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, N, dtype)
    x0, x_ref = jengine.make_benchmark_problem(cfg, dtype)
    return params, weights, cfg, jengine.NmpcState.initial(N, dtype), x0, x_ref


def _port_setup(dtype=F64, N=20, **kw):
    cfg = engine.NmpcConfig(N=N, sqp_max_iter=15, **kw)
    params = srbd.SRBDParams.create(dt=0.015, dtype=dtype, device="cpu")
    weights = engine.NmpcWeights.create(Q_DIAG, 1e-4, QF_DIAG, N, dtype,
                                        device="cpu")
    x0, x_ref = engine.make_benchmark_problem(cfg, dtype, device="cpu")
    return (params, weights, cfg, engine.NmpcState.initial(N, dtype,
                                                           device="cpu"),
            x0, x_ref)


def _batch_x0s(B=4, seed=11):
    rng = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[8] = 1.0
    return x0[None] + 0.01 * rng.normal(size=(B, 12))


@pytest.fixture(scope="module")
def jax_solves():
    out = {name: jengine.solve(*_jax_setup(**kw)) for name, kw in CASES.items()}
    # batched exact sensitivities on the xla route (N=5, B=4)
    p, w, cfg, st, _, x_ref = _jax_setup(N=5, sensitivity="exact",
                                         persistent_alpha=False)
    B = 4
    states = jengine.NmpcState(x=jnp.broadcast_to(st.x, (B,) + st.x.shape),
                               u=jnp.broadcast_to(st.u, (B,) + st.u.shape),
                               alpha=jnp.ones(B, jnp.float64))
    out["batched_exact"] = jengine.solve(p, w, cfg, states,
                                         jnp.asarray(_batch_x0s(B)), x_ref)
    return out


@pytest.fixture(scope="module")
def port_solves():
    return {name: engine.solve(*_port_setup(**kw)) for name, kw in CASES.items()}


def _assert_same_solve(got, ref, u_tol=1e-8):
    st, info = got
    st_j, info_j = ref
    for name in INFO_EXACT:
        np.testing.assert_array_equal(getattr(info, name).numpy(),
                                      np.asarray(getattr(info_j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(st_j.u), rtol=0,
                               atol=u_tol)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_j.x), rtol=0,
                               atol=1e-10)
    for name in INFO_CLOSE:
        np.testing.assert_allclose(getattr(info, name).numpy(),
                                   np.asarray(getattr(info_j, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_solve_matches_jax(jax_solves, port_solves, case):
    _assert_same_solve(port_solves[case], jax_solves[case])
    assert bool(port_solves[case][1].converged)


def test_single_solve_matches_native_oracle(port_solves):
    ok, x_c, u_c = oracle_solve(np.asarray([0] * 8 + [1.0] + [0] * 3))
    assert ok
    st, info = port_solves["default"]
    assert int(info.status) == engine.STATUS_SUCCESS
    err_u = float(np.max(np.abs(st.u.numpy() - u_c)))
    err_x = float(np.max(np.abs(st.x.numpy() - x_c)))
    assert err_u / 100.0 < 1e-4, err_u
    assert err_x < 1e-4, err_x
    assert parity_metric(st.u.numpy(), u_c) < 1e-4


def test_f32_refine_matches_native_oracle():
    """f32 with one refinement pass against the f64 oracle (the bar of
    test_native_oracle.py::test_f32_refine_xla_path_matches_native_oracle)."""
    _, _, u_c = oracle_solve(np.asarray([0] * 8 + [1.0] + [0] * 3))
    st, info = engine.solve(*_port_setup(torch.float32, refine=1))
    assert st.u.dtype == torch.float32
    err_u = float(np.max(np.abs(st.u.double().numpy() - u_c)))
    assert err_u / 100.0 < 1e-3, err_u
    assert float(info.theta) < 1e-4


def test_exact_sensitivity_beats_euler(port_solves):
    """Exact RK4 sensitivities with alpha reset reach a merit no worse
    than the Euler ones (tests/test_nmpc.py::test_exact_sensitivity_converges)."""
    _, info_x = port_solves["exact"]
    _, info_e = port_solves["default"]
    assert bool(info_x.converged)
    assert float(info_x.phi) < float(info_e.phi) + 1e-6


def test_warm_start_converges_in_one_iteration(port_solves):
    st, _ = port_solves["default"]
    p, w, cfg, _, x0, x_ref = _port_setup()
    st2, info2 = engine.solve(p, w, cfg, st, x0, x_ref)
    assert bool(info2.converged) and int(info2.sqp_iters) == 1
    # and the JAX engine takes the same warm step
    jp, jw, jcfg, _, jx0, jx_ref = _jax_setup()
    jst = jengine.NmpcState(x=jnp.asarray(st.x.numpy()),
                            u=jnp.asarray(st.u.numpy()),
                            alpha=jnp.asarray(st.alpha.numpy()))
    _assert_same_solve((st2, info2), jengine.solve(jp, jw, jcfg, jst, jx0,
                                                   jx_ref))


def test_nan_x0_reports_nan_detected():
    """A NaN initial state ends as NAN_DETECTED after one SQP iteration
    with a finite iterate (tests/test_nmpc.py::test_nan_x0_reports_nan_detected)."""
    p, w, cfg, st, x0, x_ref = _port_setup()
    x0 = x0.clone()
    x0[3] = float("nan")
    st_f, info = engine.solve(p, w, cfg, st, x0, x_ref)
    assert int(info.status) == engine.STATUS_NAN_DETECTED
    assert not bool(info.converged)
    assert int(info.sqp_iters) == 1
    assert torch.isfinite(st_f.x).all() and torch.isfinite(st_f.u).all()


def test_sqp_step_and_linearize_match_jax():
    """One SQP iteration from a random iterate (status, trips, the step)
    and the OCP-QP it linearizes, for one scenario and a batch."""
    rng = np.random.default_rng(4)
    N = 20
    x = np.zeros((N + 1, 12))
    x[:, 8] = 1.0
    x = x + 0.01 * rng.normal(size=x.shape)
    u = 100.0 + rng.normal(size=(N, 12))
    jp, jw, jcfg, _, jx0, jx_ref = _jax_setup()
    p, w, cfg, _, x0, x_ref = _port_setup()
    jst = jengine.NmpcState(x=jnp.asarray(x), u=jnp.asarray(u),
                            alpha=jnp.asarray(1.0))
    st = engine.NmpcState(x=torch.as_tensor(x), u=torch.as_tensor(u),
                          alpha=torch.tensor(1.0, dtype=F64))
    _assert_same_solve(engine.sqp_step(p, w, cfg, st, x0, x_ref),
                       jengine.sqp_step(jp, jw, jcfg, jst, jx0, jx_ref))

    xb, ub = np.stack([x, x[::-1]]), np.stack([u, u[::-1]])
    for xs, us in ((x, u), (xb, ub)):
        qj = jengine.linearize(jp, jw, jcfg, jengine.NmpcState(
            x=jnp.asarray(xs), u=jnp.asarray(us), alpha=jnp.ones(())),
            jx_ref)
        qp = engine.linearize(p, w, cfg, engine.NmpcState(
            x=torch.as_tensor(xs), u=torch.as_tensor(us),
            alpha=torch.ones((), dtype=F64)), x_ref)
        for name in ("A", "B", "b", "Q", "S", "R", "q", "r"):
            np.testing.assert_allclose(getattr(qp, name).numpy(),
                                       np.asarray(getattr(qj, name)),
                                       rtol=1e-11, atol=1e-11, err_msg=name)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("qp_kernel", ["auto", "xla"])
def test_merit_fast_and_merit_match_jax(batched, qp_kernel):
    """``merit`` and ``_merit_fast`` (with and without gradients). This
    float64 batch takes the plain merit under either setting (K7b's branch
    takes float32 batches under ``qp_kernel="auto"``); JAX takes its plain
    merit on the CPU either way."""
    rng = np.random.default_rng(5)
    N, B = 20, 8
    shape = (B,) if batched else ()
    x = rng.normal(size=shape + (N + 1, 12)) * 0.1
    u = 90.0 + 20.0 * rng.normal(size=shape + (N, 12))
    jp, jw, jcfg, _, _, jx_ref = _jax_setup(qp_kernel=qp_kernel,
                                            pallas_block=4)
    p, w, cfg, _, _, x_ref = _port_setup(qp_kernel=qp_kernel, pallas_block=4)
    before = dict(merit_kernel.launches)
    for g in (False, True):
        got = engine._merit_fast(p, w, cfg, torch.as_tensor(x),
                                 torch.as_tensor(u), x_ref, with_grad=g)
        ref = jengine._merit_fast(jp, jw, jcfg, jnp.asarray(x), jnp.asarray(u),
                                  jx_ref, with_grad=g)
        assert len(got) == len(ref) == (6 if g else 4)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
        got = engine.merit(p, w, cfg, torch.as_tensor(x), torch.as_tensor(u),
                           x_ref, with_grad=g)
        ref = jengine.merit(jp, jw, jcfg, jnp.asarray(x), jnp.asarray(u),
                            jx_ref, with_grad=g)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    assert merit_kernel.launches == before   # CPU: no kernel launch
    assert engine._pallas_eligible(cfg, B, torch.float32) == (
        qp_kernel == "auto")
    assert not engine._pallas_eligible(cfg, B, F64)


def test_batched_exact_route_matches_jax(jax_solves):
    """``sensitivity="exact"`` on a batch takes the plain ``xla`` route
    with the RK4 map's Jacobians (B=4, N=5)."""
    p, w, cfg, st, _, x_ref = _port_setup(N=5, sensitivity="exact",
                                          persistent_alpha=False)
    B = 4
    states = engine.NmpcState(x=st.x.expand((B,) + st.x.shape).contiguous(),
                              u=st.u.expand((B,) + st.u.shape).contiguous(),
                              alpha=torch.ones(B, dtype=F64))
    assert engine._qp_route(cfg) == "xla"
    got = engine.solve(p, w, cfg, states, torch.as_tensor(_batch_x0s(B)),
                       x_ref)
    _assert_same_solve(got, jax_solves["batched_exact"])


def test_single_solve_ignores_batched_only_options(port_solves):
    """The single scenario runs no kernel: a ``fused`` QP kernel or
    ``park_factor`` (batched-only options) leave its solve unchanged, as
    in the JAX engine."""
    p, w, cfg, st, x0, x_ref = _port_setup()
    got = engine.solve(p, w, dataclasses.replace(cfg, qp_kernel="fused",
                                                 park_factor=True),
                       st, x0, x_ref)
    ref_st, ref_info = port_solves["default"]
    assert torch.equal(got[0].u, ref_st.u)
    assert torch.equal(got[1].sqp_iters, ref_info.sqp_iters)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_solve_is_a_batch_of_one(port_solves, case):
    """One scenario is a batch of one on the plain ``xla`` route: the same
    iterate and diagnostics, bit for bit, as that batch's solve."""
    p, w, cfg, st, x0, x_ref = _port_setup(**CASES[case])
    batch = engine.NmpcState(x=st.x[None], u=st.u[None],
                             alpha=st.alpha.reshape(1))
    st_b, info_b = engine.solve(p, w, dataclasses.replace(cfg, qp_kernel="xla"),
                                batch, x0[None], x_ref)
    st_s, info_s = port_solves[case]
    assert st_s.x.shape == st.x.shape and info_s.status.dim() == 0
    assert torch.equal(st_s.x, st_b.x[0]) and torch.equal(st_s.u, st_b.u[0])
    for f in dataclasses.fields(info_s):
        assert torch.equal(getattr(info_s, f.name),
                           getattr(info_b, f.name)[0]), f.name
