"""PyTorch port of the lane permutes (kernel K2): the plain versions vs the
JAX ``permute_pallas`` kernels in interpret mode, bitwise."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.ops import permute_pallas as pp
from srbd_nmpc_tpu_torch.ops import permute

torch.set_num_threads(1)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield
    monkeypatch.undo()


def _sorted_idx(rng, B, Bc, clumpy=False):
    if clumpy:
        p = np.ones(B)
        p[: B // 3] = 8.0
        p[-B // 5:] = 0.05
        p /= p.sum()
        return np.sort(rng.choice(B, size=Bc, replace=False, p=p))
    return np.sort(rng.choice(B, size=Bc, replace=False))


@pytest.mark.parametrize("clumpy", [False, True])
def test_take_lanes_bitwise_vs_jax_kernel(interpret_pallas, clumpy):
    rng = np.random.default_rng(3 + clumpy)
    B, Bc = 4096, 1024
    a = rng.normal(size=(5, 12, B)).astype(np.float32)
    idx = _sorted_idx(rng, B, Bc, clumpy)
    ref = pp.take_lanes(jnp.asarray(a), jnp.asarray(idx, jnp.int32),
                        window=8, force=True)
    before = dict(permute.launches)
    got = permute.take_lanes(torch.as_tensor(a), torch.as_tensor(idx))
    assert permute.launches == before   # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("clumpy", [False, True])
def test_set_lanes_bitwise_vs_jax_kernel(interpret_pallas, clumpy):
    rng = np.random.default_rng(17 + clumpy)
    B, Bc = 4096, 1024
    orig = rng.normal(size=(5, 12, B)).astype(np.float32)
    src = rng.normal(size=(5, 12, Bc)).astype(np.float32)
    idx = _sorted_idx(rng, B, Bc, clumpy)
    ref = pp.set_lanes(jnp.asarray(orig), jnp.asarray(src),
                       jnp.asarray(idx, jnp.int32), force=True)
    o = torch.as_tensor(orig)
    got = permute.set_lanes(o, torch.as_tensor(src), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(o.numpy(), orig)   # input left untouched


def test_dense_prefix_and_any_width():
    # compaction's common case (idx = 0..Bc-1) and widths the TPU kernels
    # could not take (not multiples of 256)
    rng = np.random.default_rng(23)
    for B, Bc in ((2048, 512), (500, 77)):
        orig = torch.as_tensor(rng.normal(size=(7, B)))
        src = torch.as_tensor(rng.normal(size=(7, Bc)))
        idx = torch.as_tensor(np.sort(rng.choice(B, Bc, replace=False)))
        for ix in (torch.arange(Bc), idx):
            out = permute.set_lanes(orig, src, ix)
            ref = orig.clone()
            ref[:, ix] = src
            assert torch.equal(out, ref)
            assert torch.equal(permute.take_lanes(out, ix), src)
