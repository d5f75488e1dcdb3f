"""The port's Riccati LQR solve (``ops/riccati_soa.py``, which the single
scenario and the batched ``xla`` route share) vs the JAX single scenario's
``ops/riccati.py``, f64, on the random strictly convex QPs of
``tests/test_riccati.py`` (N=20, nx=5, nu=3), one QP as a batch of one
(B=1) like the engine's single scenario. Tolerance: 1e-10 absolute on every
output (the recursion's small products and triangular solves round in
another order than XLA's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.ops import riccati as jric
from srbd_nmpc_tpu_torch.ops import riccati_soa
from test_riccati import random_qp

torch.set_num_threads(1)
FIELDS = ("A", "B", "b", "Q", "S", "R", "q", "r")
TOL = 1e-10


def _soa(qp, *qps):
    """The QPs' fields stacked batch-last ([N, n, m, B]), as the engine
    hands them to ``lqr_solve``."""
    return [torch.stack([torch.as_tensor(np.array(getattr(p, k)))
                         for p in (qp,) + qps], dim=-1) for k in FIELDS]


def _bf(qp):
    """One QP's fields with a leading batch axis of one ([1, N, n, m])."""
    return [torch.as_tensor(np.array(getattr(qp, k)))[None] for k in FIELDS]


def _x0(n=5, seed=5):
    return np.random.default_rng(seed).uniform(-1, 1, size=n)


@pytest.mark.parametrize("kw", [dict(), dict(refine=1),
                                dict(reg=1e-9, refine=2)])
def test_lqr_solve_matches_jax(kw):
    qp = random_qp(seed=31)
    x0 = _x0()
    ref = jric.lqr_solve(qp, jnp.asarray(x0), **kw)
    got = riccati_soa.lqr_solve(*_soa(qp), torch.as_tensor(x0)[:, None], **kw)
    for name, g in zip(("x", "u", "pi"), got):
        np.testing.assert_allclose(g[..., 0].numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL,
                                   err_msg=name)


def test_kkt_residuals_and_sweeps_match_jax():
    """KKT residuals at a random point, the backward sweep (P, p, K, k) and
    the forward rollout, against ``kkt_residuals``, ``lqr_backward`` and
    ``lqr_forward``; the solve's own residuals vanish."""
    qp = random_qp(N=12, seed=32)
    A, B, b, Q, S, R, q, r = _bf(qp)
    x0 = _x0(seed=6)
    rng = np.random.default_rng(7)
    x, u, pi = (rng.normal(size=s) for s in ((13, 5), (12, 3), (13, 5)))
    got = riccati_soa.kkt_residuals(A, B, b, Q, S, R, q, r,
                                    *(torch.as_tensor(a)[None]
                                      for a in (x, u, pi)))
    ref = jric.kkt_residuals(qp, *(jnp.asarray(a) for a in (x, u, pi)))
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(rr), atol=TOL)
    fac = riccati_soa.factorize(A, B, Q, S, R)
    xs, us, _, p, k = riccati_soa.solve_vectors(
        fac, A, B, b, q, r, torch.as_tensor(x0)[None])
    for g, rr in zip((fac.P, p, fac.K, k), jric.lqr_backward(qp)):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(rr), atol=TOL)
    for g, rr in zip((xs, us), jric.lqr_forward(qp, jnp.asarray(x0),
                                                jnp.asarray(fac.K[0].numpy()),
                                                jnp.asarray(k[0].numpy()))):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(rr), atol=TOL)
    sol = riccati_soa.lqr_solve(*_soa(qp), torch.as_tensor(x0)[:, None])
    for res in riccati_soa.kkt_residuals(
            A, B, b, Q, S, R, q, r, *(t.movedim(-1, 0) for t in sol)):
        assert float(res.abs().max()) < 1e-9


def test_factors_match_jax():
    """The factorization (P, K, L, H) against ``riccati_factorize``."""
    qp = random_qp(N=15, seed=77)
    A, B, _, Q, S, R, _, _ = _bf(qp)
    got = riccati_soa.factorize(A, B, Q, S, R)
    ref = jric.riccati_factorize(qp.A, qp.B, qp.Q, qp.S, qp.R)
    for name in ("P", "K", "L", "H"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL,
                                   err_msg=name)


def test_batched_leading_axis_and_nan_on_indefinite():
    """A batch solves each QP as alone; a G that is not positive definite
    gives NaN (no exception, no host read), as JAX's Cholesky does."""
    qps = [random_qp(N=6, seed=s) for s in (1, 2)]
    x0s = np.stack([_x0(seed=8), _x0(seed=9)], axis=-1)       # [nx, B]
    both = riccati_soa.lqr_solve(*_soa(*qps), torch.as_tensor(x0s))
    for i, q in enumerate(qps):
        one = riccati_soa.lqr_solve(*_soa(q), torch.as_tensor(x0s[:, i:i + 1]))
        for a, b in zip(both, one):
            np.testing.assert_allclose(a[..., i].numpy(), b[..., 0].numpy(),
                                       atol=1e-12)
    bad = _soa(qps[0])
    bad[5] = -bad[5]                                          # R -> -R
    x, u, _ = riccati_soa.lqr_solve(*bad, torch.as_tensor(x0s[:, :1]))
    assert torch.isnan(u).all()
    ref = jric.lqr_solve(
        type(qps[0])(**{k: jnp.asarray(t[..., 0].numpy())
                        for k, t in zip(FIELDS, bad)}), jnp.asarray(x0s[:, 0]))
    assert np.isnan(np.asarray(ref.u)).all()
