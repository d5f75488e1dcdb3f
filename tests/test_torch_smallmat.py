"""PyTorch port: batch-last small-matrix k-loops vs the JAX package (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.ops import smallmat as jsm
from srbd_nmpc_tpu_torch.ops import smallmat as sm

torch.set_num_threads(1)
B = 24


def _spd(rng, n=12):
    a = rng.normal(size=(n, n, B))
    g = np.einsum("kib,kjb->ijb", a, a)
    return g + n * np.eye(n)[:, :, None]


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_cholesky_and_substitutions():
    rng = np.random.default_rng(0)
    G = _spd(rng)
    R = rng.normal(size=(12, 13, B))
    L, d = sm.cholesky(torch.as_tensor(G))
    Lj, dj = jsm.cholesky(jnp.asarray(G))
    _close(L, Lj)
    _close(d, dj)
    Y = sm.fwd_subst(L, d, torch.as_tensor(R))
    _close(Y, jsm.fwd_subst(Lj, dj, jnp.asarray(R)))
    _close(sm.bwd_subst(L, d, Y), jsm.bwd_subst(Lj, dj, jnp.asarray(np.asarray(Y))))
    # and it solves the system
    X = sm.bwd_subst(L, d, Y).numpy()
    np.testing.assert_allclose(np.einsum("ijb,jkb->ikb", G, X), R,
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,shapes", [
    ("mm", ((12, 7, B), (7, 5, B))),
    ("mtm", ((7, 12, B), (7, 5, B))),
    ("mv", ((12, 7, B), (7, B))),
    ("mtv", ((7, 12, B), (7, B))),
])
def test_products(name, shapes):
    rng = np.random.default_rng(1)
    args = [rng.normal(size=s) for s in shapes]
    got = getattr(sm, name)(*(torch.as_tensor(a) for a in args))
    _close(got, getattr(jsm, name)(*(jnp.asarray(a) for a in args)))


def test_gram_matches_jax_and_is_bitwise_mtm_after_symmetrization():
    rng = np.random.default_rng(2)
    y = torch.as_tensor(rng.normal(size=(12, 12, B)))
    g = sm.gram(y)
    _close(g, jsm.gram(jnp.asarray(y.numpy())))
    m = sm.mtm(y, y)
    assert torch.equal(0.5 * (g + g.transpose(0, 1)),
                       0.5 * (m + m.transpose(0, 1)))


def test_add_diag():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6, B))
    _close(sm.add_diag(torch.as_tensor(a), 0.25),
           jsm.add_diag(jnp.asarray(a), 0.25))


@pytest.mark.parametrize("name,shapes", [
    ("mmt", ((12, 7, B), (5, 7, B))),
    ("transpose", ((12, 7, B),)),
    ("sym", ((12, 12, B),)),
])
def test_products_and_symmetrization(name, shapes):
    rng = np.random.default_rng(4)
    args = [rng.normal(size=s) for s in shapes]
    got = getattr(sm, name)(*(torch.as_tensor(a) for a in args))
    _close(got, getattr(jsm, name)(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("name,rhs", [("chol_solve", (12, 13, B)),
                                      ("chol_solve_vec", (12, B))])
def test_chol_solve(name, rhs):
    rng = np.random.default_rng(5)
    G = _spd(rng)
    R = rng.normal(size=rhs)
    L, d = sm.cholesky(torch.as_tensor(G))
    Lj, dj = jsm.cholesky(jnp.asarray(G))
    got = getattr(sm, name)(L, d, torch.as_tensor(R))
    _close(got, getattr(jsm, name)(Lj, dj, jnp.asarray(R)))
