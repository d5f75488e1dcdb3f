"""PyTorch port of ``ops/so3.py`` vs the JAX module, f64, on random
rotation vectors with two leading batch axes (one of them at the
small-angle clamp), and ``torch.func`` tracing of the chain the exact
sensitivities differentiate. Tolerance: rtol 1e-12, atol 1e-14 (same
formulas; only the rounding of the 3x3 products and library
transcendentals may differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.ops import so3 as jso3
from srbd_nmpc_tpu_torch.ops import so3

torch.set_num_threads(1)


def _vecs(seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4, 5, 3)) * 0.8
    v[0, 0] = 0.0              # zero rotation: the small-angle clamp
    v[0, 1] = [1e-12, 0, 0]    # below the f64 clamp
    return v


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("name", ["skew", "expm", "jl", "jl_inv", "djl",
                                  "djl_inv"])
def test_vector_functions_match_jax(name):
    v = _vecs()
    _close(getattr(so3, name)(torch.as_tensor(v)),
           getattr(jso3, name)(jnp.asarray(v)))


@pytest.mark.parametrize("name", ["rotx", "roty", "rotz"])
def test_rotations_match_jax(name):
    a = np.random.default_rng(1).uniform(-np.pi, np.pi, size=(3, 4))
    _close(getattr(so3, name)(torch.as_tensor(a)),
           getattr(jso3, name)(jnp.asarray(a)))


def test_unskew_and_logm_match_jax():
    """logm on generic rotations, the identity and rotations by pi about
    each axis (its three branches); unskew inverts skew."""
    v = _vecs(2)
    R = np.array(jso3.expm(jnp.asarray(v)))
    R[0, 0] = np.eye(3)
    R[1, 0] = np.asarray(jso3.rotx(jnp.asarray(np.pi)))
    R[1, 1] = np.asarray(jso3.roty(jnp.asarray(np.pi)))
    R[1, 2] = np.asarray(jso3.rotz(jnp.asarray(np.pi)))
    _close(so3.logm(torch.as_tensor(R)), jso3.logm(jnp.asarray(R)))
    np.testing.assert_array_equal(
        so3.unskew(so3.skew(torch.as_tensor(v))).numpy(), v)


def test_jl_inverse_pair_and_jacfwd_trace():
    """jl_inv is jl's inverse; torch.func.jacfwd of expm (no in-place
    write in the chain) equals JAX's jax.jacfwd."""
    v = _vecs(3)[1:]
    t = torch.as_tensor(v)
    eye = np.broadcast_to(np.eye(3), v.shape[:-1] + (3, 3))
    np.testing.assert_allclose((so3.jl(t) @ so3.jl_inv(t)).numpy(), eye,
                               atol=1e-12)
    got = torch.func.vmap(torch.func.jacfwd(so3.expm))(t.reshape(-1, 3))
    ref = jax.vmap(jax.jacfwd(jso3.expm))(jnp.asarray(v.reshape(-1, 3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)
