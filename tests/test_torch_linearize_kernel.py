"""PyTorch port of the stage linearization (kernel K5): the plain version vs
the JAX ``linearize_pallas`` in interpret mode, f64 (the CUDA source's two
launches, built as host C++, are held to the plain version by
test_torch_linearize_split.py).

Tolerance: rtol 1e-12 against JAX (same formulas; row sums may be taken in
another order), with an absolute floor of 1e-12 for entries that cancel to
~0."""

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
from srbd_nmpc_tpu_torch.models import srbd, srbd_linearize

torch.set_num_threads(1)
F64 = torch.float64
MU_B, THETA_B = 0.1, 5.0
N, B = 5, 16
NAMES = ("A", "B", "b", "q", "r_eff", "R_eff", "mer")


def _problem(seed=0):
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=jnp.float64)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N,
        jnp.float64)
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(N + 1, 12, B)) * 0.3
    xa[0, 0:3, 0] = 0.0                          # the small-angle clamp
    us = rng.normal(size=(N, 12, B)) * 30 + 80
    us[1, 0:3, 1] = -5.0                          # a row in the quadratic branch
    xr = rng.normal(size=(N, 12, B)) * 0.1
    return params, weights, (xa[:-1], xa[1:], us, xr)


def _port(params, weights):
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name))
         for f in dataclasses.fields(params)}, dtype=F64, device="cpu")
    tw = convert.weights_from_numpy(
        {f.name: np.asarray(getattr(weights, f.name))
         for f in dataclasses.fields(weights)}, dtype=F64, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    return tp, tw, Ac, bc


@pytest.fixture(scope="module")
def jax_ref():
    from srbd_nmpc_tpu.models import srbd_pallas

    params, weights, arrs = _problem()
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        Ac, bc = jsrbd.constraint_matrix(params)
        out = srbd_pallas.linearize_pallas(
            params, weights.Q, weights.R, Ac, bc,
            *(jnp.asarray(a) for a in arrs), MU_B, THETA_B, block=8)
        return params, weights, arrs, [np.asarray(o) for o in out]
    finally:
        pl.pallas_call = orig


def _plain(params, weights, arrs):
    tp, tw, Ac, bc = _port(params, weights)
    before = srbd_linearize.launches
    out = srbd_linearize.linearize(
        tp, tw.Q, tw.R, Ac, bc,
        *(torch.as_tensor(np.ascontiguousarray(a)) for a in arrs),
        MU_B, THETA_B)
    assert srbd_linearize.launches == before   # CPU tensors: the plain version
    return out


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)))
def test_plain_matches_jax_kernel(jax_ref, i, name):
    params, weights, arrs, ref = jax_ref
    got = _plain(params, weights, arrs)[i]
    assert tuple(got.shape) == ref[i].shape, name
    np.testing.assert_allclose(got.numpy(), ref[i], rtol=1e-12, atol=1e-12,
                               err_msg=name)
