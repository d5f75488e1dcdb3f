"""PyTorch port of ``ops/riccati_soa.py`` (the ``xla`` route's QP solve) vs
the JAX module, f64: ``lqr_solve`` without and with iterative refinement,
and the factorization and KKT residuals it is built from. Tolerance: rtol
1e-10 (a Cholesky sits between inputs and outputs, and the port's batched
library factorization rounds in another order than JAX's k-loops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.ops import riccati_soa as jric
from srbd_nmpc_tpu_torch.ops import riccati_soa

torch.set_num_threads(1)
N, B = 5, 8


def _problem(seed=0):
    """As tests/test_riccati_pallas.py:make_problem, with a cross term S."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: rng.normal(size=s)          # noqa: E731
    A = rnd(N, 12, 12, B) * 0.2 + np.eye(12)[..., None]
    Bm = rnd(N, 12, 12, B) * 0.1
    b = rnd(N, 12, B) * 0.1
    Qh = rnd(N + 1, 12, 12, B)
    Q = np.einsum("nikb,njkb->nijb", Qh, Qh) * 0.1 + np.eye(12)[..., None]
    S = rnd(N, 12, 12, B) * 0.01
    Rh = rnd(N, 12, 12, B)
    R = np.einsum("nikb,njkb->nijb", Rh, Rh) * 0.1 + np.eye(12)[..., None]
    q = rnd(N + 1, 12, B)
    r = rnd(N, 12, B)
    x0 = rnd(12, B)
    return A, Bm, b, Q, S, R, q, r, x0


def _close(got, ref, rtol=1e-10):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=1e-10)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_lqr_solve_matches_jax(refine):
    args = _problem()
    got = riccati_soa.lqr_solve(*(torch.as_tensor(a) for a in args),
                                reg=1e-9, refine=refine)
    ref = jric.lqr_solve(*(jnp.asarray(a) for a in args), reg=1e-9,
                         refine=refine)
    for g, r in zip(got, ref):
        _close(g, r)


def test_factorize_and_kkt_residuals_match_jax():
    """The recursion runs batch-first ([B, N, n, m]); its factors and the
    KKT residuals, moved back to SoA, against JAX's (``dinv``, which the
    port's triangular solves do not use, is checked through L)."""
    A, Bm, b, Q, S, R, q, r, x0 = _problem(1)
    T = [torch.as_tensor(a).movedim(-1, 0)
         for a in (A, Bm, b, Q, S, R, q, r, x0)]
    J = [jnp.asarray(a) for a in (A, Bm, b, Q, S, R, q, r, x0)]
    fac = riccati_soa.factorize(T[0], T[1], T[3], T[4], T[5], reg=1e-9)
    fac_j = jric.factorize(J[0], J[1], J[3], J[4], J[5], reg=1e-9)
    for name in ("P", "K", "L", "H"):
        _close(getattr(fac, name).movedim(0, -1), getattr(fac_j, name))
    _close(1.0 / torch.diagonal(fac.L, dim1=-2, dim2=-1).movedim(0, -1),
           fac_j.dinv)
    x, u, pi = riccati_soa.lqr_solve(*(torch.as_tensor(a) for a in
                                       (A, Bm, b, Q, S, R, q, r, x0)),
                                     reg=1e-9)
    res = riccati_soa.kkt_residuals(*T[:8], *(t.movedim(-1, 0)
                                               for t in (x, u, pi)))
    res_j = jric.kkt_residuals_soa(*J[:8], *(jnp.asarray(t.numpy())
                                             for t in (x, u, pi)))
    for g, rr in zip(res, res_j):
        _close(g.movedim(0, -1), rr)
        assert float(g.abs().max()) < 1e-8   # the solve satisfies the KKT
