"""PyTorch port: model constants, constraint rows, barrier, SO(3) clamp,
stage-plane linearization and parameter conversion vs the JAX package (f64)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.models import srbd_planes as jspl
from srbd_nmpc_tpu.models import srbd_soa as jsoa
from srbd_nmpc_tpu.ops import barrier as jbarrier
from srbd_nmpc_tpu.ops import so3 as jso3
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import srbd, srbd_planes, srbd_soa
from srbd_nmpc_tpu_torch.ops import barrier, so3

torch.set_num_threads(1)
F64 = torch.float64


def _jax_params_dict(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def test_constants_match():
    assert (srbd.NX, srbd.NU, srbd.NG, srbd.GRAVITY) == (
        jsrbd.NX, jsrbd.NU, jsrbd.NG, jsrbd.GRAVITY)


def test_params_create_matches_jax():
    jp = jsrbd.SRBDParams.create(dt=0.02, mass=12.0, dtype=jnp.float64)
    tp = srbd.SRBDParams.create(dt=0.02, mass=12.0, dtype=F64, device="cpu")
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                      np.asarray(getattr(jp, f.name)))


def test_constraint_matrix_exact():
    jp = jsrbd.SRBDParams.create(mu=0.7, fmin=2.0, dtype=jnp.float64)
    tp = convert.params_from_numpy(_jax_params_dict(jp), dtype=F64,
                                    device="cpu")
    Ac_j, bc_j = jsrbd.constraint_matrix(jp)
    Ac_t, bc_t = srbd.constraint_matrix(tp)
    np.testing.assert_array_equal(Ac_t.numpy(), np.asarray(Ac_j))
    np.testing.assert_array_equal(bc_t.numpy(), np.asarray(bc_j))


def test_params_round_trip_through_convert():
    jp = jsrbd.SRBDParams.create(mass=17.5, dt=0.01, dtype=jnp.float64)
    d = _jax_params_dict(jp)
    tp = convert.params_from_numpy(d, dtype=F64, device="cpu")
    for name, arr in d.items():
        np.testing.assert_array_equal(getattr(tp, name).numpy(), arr)
    with pytest.raises(KeyError, match="missing"):
        convert.params_from_numpy({k: v for k, v in d.items() if k != "mu"},
                                  device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.params_from_numpy({**d, "bogus": 1.0}, device="cpu")


def test_relaxed_log_barrier_straddling_theta():
    rng = np.random.default_rng(0)
    theta = 5.0
    v = np.concatenate([rng.uniform(-20, theta, 64), [theta, theta + 1e-9],
                        rng.uniform(theta, 200, 64)])
    for got, ref in zip(barrier.relaxed_log_barrier(torch.as_tensor(v), 0.1,
                                                    theta),
                        jbarrier.relaxed_log_barrier(jnp.asarray(v), 0.1,
                                                     theta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14,
                                   atol=0)


def test_so3_clamp_matches_jax():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.normal(size=(16, 3)), 1e-12 * np.ones((2, 3)),
                        np.zeros((1, 3))])
    assert so3._theta_min(torch.float32) == jso3._theta_min(jnp.float32)
    assert so3._theta_min(F64) == jso3._theta_min(jnp.float64)
    np.testing.assert_allclose(so3._safe_theta(torch.as_tensor(v)).numpy(),
                               np.asarray(jso3._safe_theta(jnp.asarray(v))),
                               rtol=1e-15)


def test_skew_cross_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(3, 7)), rng.normal(size=(3, 7))
    np.testing.assert_array_equal(srbd_soa.skew(torch.as_tensor(a)).numpy(),
                                  np.asarray(jsoa.skew(jnp.asarray(a))))
    np.testing.assert_allclose(
        srbd_soa.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jsoa.cross(jnp.asarray(a), jnp.asarray(b))), rtol=1e-15)


def test_linearize_stage_matches_jax_twin():
    rng = np.random.default_rng(3)
    N, B = 5, 16
    x = rng.normal(size=(12, N, B)) * 0.3
    x[0:3, 0, 0] = 0.0              # a zero rotation exercises the clamp
    u = rng.normal(size=(12, N, B)) * 30 + 80
    jp = jsrbd.SRBDParams.create(dtype=jnp.float64)
    tp = convert.params_from_numpy(_jax_params_dict(jp), dtype=F64,
                                    device="cpu")

    def consts(p, conv):
        iv, ft = p.inertia_inv, p.foot_pos
        return (p.mass, p.dt,
                tuple(tuple(iv[i, j] for j in range(3)) for i in range(3)),
                tuple(ft[0, j] for j in range(3)),
                tuple(ft[1, j] for j in range(3)),
                tuple(conv(x[e]) for e in range(12)),
                tuple(conv(u[e]) for e in range(12)))

    ref = jspl.linearize_stage(*consts(jp, jnp.asarray))
    got = srbd_planes.linearize_stage(*consts(tp, torch.as_tensor))

    def flat(t):
        if isinstance(t, (tuple, list)):
            return [y for s in t for y in flat(s)]
        return [t]

    got_f, ref_f = flat(got), flat(ref)
    assert len(got_f) == len(ref_f) == 9 + 9 + 9 + 12
    for g, r in zip(got_f, ref_f):
        if isinstance(r, float):
            assert g == r
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                       rtol=1e-12, atol=1e-12)
