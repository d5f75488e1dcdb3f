"""PyTorch port of ``models/srbd.py``'s AoS model (continuous dynamics, RK4
and the exact sensitivities of the RK4 map) and of the Euler
sensitivities the solves use (``models/srbd_soa.euler_AB``) vs the JAX
module, f64, on random states with two leading batch axes. Tolerances:
rtol 1e-12 for the closed-form functions (same formulas; only the rounding
of small products may differ), 1e-10 for the exact sensitivities
(``torch.func.jacfwd`` vs ``jax.jacfwd``: the same chain rule,
differentiated by two tracers)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import srbd, srbd_soa
from srbd_nmpc_tpu_torch.nmpc import engine

torch.set_num_threads(1)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 4, 12)) * 0.4
    x[0, 0, 0:3] = 0.0          # zero rotation: the small-angle clamp
    xn = x + rng.normal(size=x.shape) * 0.01
    u = rng.normal(size=(3, 4, 12)) * 30 + 80
    jp = jsrbd.SRBDParams.create(dtype=jnp.float64)
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp)}, dtype=torch.float64, device="cpu")
    return jp, tp, x, xn, u


def _close(got, ref, rtol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=rtol * 1e-2)


@pytest.mark.parametrize("name", ["continuous_dynamics", "rk4_step"])
def test_model_functions_match_jax(name):
    jp, tp, x, _, u = _inputs()
    got = getattr(srbd, name)(tp, torch.as_tensor(x), torch.as_tensor(u))
    ref = getattr(jsrbd, name)(jp, jnp.asarray(x), jnp.asarray(u))
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(g, r)


@pytest.mark.parametrize("sensitivity,rtol", [("euler", 1e-12),
                                              ("exact", 1e-10)])
def test_linearize_shooting_matches_jax(sensitivity, rtol):
    """JAX's (A, B): the exact ones are ``srbd.rk4_jacobians``
    (torch.func.jacfwd over rk4_step, vmapped over both leading axes), the
    Euler ones ``srbd_soa.euler_AB`` in SoA layout."""
    jp, tp, x, xn, u = _inputs(1)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    if sensitivity == "exact":
        got = srbd.rk4_jacobians(tp, tx, tu)
    else:
        got = tuple(J.movedim(0, -1).movedim(0, -1)
                    for J in srbd_soa.euler_AB(tp, tx.movedim(-1, 0),
                                               tu.movedim(-1, 0)))
    ref = jsrbd.linearize_shooting(jp, jnp.asarray(x), jnp.asarray(xn),
                                   jnp.asarray(u), sensitivity)
    assert got[0].shape == (3, 4, 12, 12) and got[1].shape == (3, 4, 12, 12)
    for g, r in zip(got, ref[:2]):
        _close(g, r, rtol)


def test_exact_sensitivity_one_scenario_matches_jax():
    """One leading (stage) axis, as one scenario's stages are; an unknown
    sensitivity mode raises in the solve, as in JAX."""
    jp, tp, x, xn, u = _inputs(2)
    got = srbd.rk4_jacobians(tp, torch.as_tensor(x[0]), torch.as_tensor(u[0]))
    ref = jsrbd.linearize_shooting(jp, jnp.asarray(x[0]), jnp.asarray(xn[0]),
                                   jnp.asarray(u[0]), "exact")
    for g, r in zip(got, ref[:2]):
        _close(g, r, 1e-10)
    cfg = engine.NmpcConfig(N=3, sensitivity="bogus")
    with pytest.raises(ValueError, match="sensitivity"):
        engine.solve(tp, engine.NmpcWeights.create(
            [1.0] * 12, 1e-4, [1.0] * 12, 3, torch.float64, device="cpu"),
            cfg, engine.NmpcState.initial(3, torch.float64, device="cpu"),
            torch.zeros(12, dtype=torch.float64),
            torch.zeros((4, 12), dtype=torch.float64))
