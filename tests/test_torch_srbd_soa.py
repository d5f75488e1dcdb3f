"""PyTorch port of ``models/srbd_soa.py`` (dynamics, Jacobians, four-call
RK4, Euler sensitivities) vs the JAX module, f64, on random states with two
trailing batch axes. Tolerance: rtol 1e-12 (same formulas in the same
order; only the rounding of library transcendentals may differ)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.models import srbd_soa as jsoa
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import srbd_soa

torch.set_num_threads(1)
SHAPE = (12, 5, 7)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE) * 0.4
    x[:, 0, 0] = 0.0          # zero rotation: the small-angle clamp
    u = rng.normal(size=SHAPE) * 30 + 80
    jp = jsrbd.SRBDParams.create(dtype=jnp.float64)
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp)}, dtype=torch.float64,
        device="cpu")
    return jp, tp, x, u


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["dynamics", "rk4", "jacobians", "euler_AB",
                                  "jacobian_blocks"])
def test_matches_jax(name):
    jp, tp, x, u = _inputs()
    got = getattr(srbd_soa, name)(tp, torch.as_tensor(x), torch.as_tensor(u))
    ref = getattr(jsoa, name)(jp, jnp.asarray(x), jnp.asarray(u))
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
    else:
        _close(got, ref)


def test_so3_chain_matches_jax():
    _, _, x, _ = _inputs(1)
    got = srbd_soa.so3_chain(torch.as_tensor(x[0:3]))
    ref = jsoa.so3_chain(jnp.asarray(x[0:3]))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k])
