"""PyTorch port of the batched merit: the line-search merit at a candidate
(kernel K7a) and the merit with diagnostics and gradients (K7b, both
variants). The plain versions vs the JAX ``merit_alpha_pallas`` /
``merit_pallas`` in interpret mode, f64; and K7b's per-scenario
arithmetic, built as host C++ in f64, vs the plain version (K7a's two
launches are held the same way by test_torch_merit_split.py).

Tolerance: rtol 1e-12 (same formulas; the JAX row sums may be taken in
another order); the host build against the plain version also rtol 1e-12
(same order, f64)."""

import ctypes
import dataclasses
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import merit_kernel, srbd, srbd_linearize
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64 = torch.float64
MU_B, THETA_B = 0.1, 5.0
N, B = 5, 16
ORDER = ("x", "u", "xr", "dx", "du", "alpha")


def _problem(seed=0):
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=jnp.float64)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N,
        jnp.float64)
    rng = np.random.default_rng(seed)
    arr = dict(
        x=rng.normal(size=(N + 1, 12, B)) * 0.3,
        u=rng.normal(size=(N, 12, B)) * 30 + 80,
        xr=rng.normal(size=(N + 1, 12, B)) * 0.1,
        dx=rng.normal(size=(N + 1, 12, B)) * 0.05,
        du=rng.normal(size=(N, 12, B)) * 2.0,
        alpha=rng.random(B),
    )
    arr["alpha"][0] = 0.0
    arr["alpha"][1] = 1.0
    return params, weights, arr


def _port(params, weights, arr):
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name))
         for f in dataclasses.fields(params)}, dtype=F64, device="cpu")
    tw = convert.weights_from_numpy(
        {f.name: np.asarray(getattr(weights, f.name))
         for f in dataclasses.fields(weights)}, dtype=F64, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    return (tp, tw.Q, tw.Qf, tw.R, Ac, bc,
            *(torch.as_tensor(arr[k]) for k in ORDER), MU_B, THETA_B)


@pytest.fixture(scope="module")
def jax_ref_k7b():
    """JAX merit_pallas (both variants) on the same inputs, interpret mode."""
    from srbd_nmpc_tpu.models import merit_pallas

    params, weights, arr = _problem()
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        Ac, bc = jsrbd.constraint_matrix(params)
        outs = {g: [None if o is None else np.asarray(o)
                    for o in merit_pallas.merit_pallas(
                        params, weights.Q, weights.Qf, weights.R, Ac, bc,
                        *(jnp.asarray(arr[k]) for k in ORDER[:3]), MU_B,
                        THETA_B, block=8, with_grad=g)]
                for g in (True, False)}
        return params, weights, arr, outs
    finally:
        pl.pallas_call = orig


@pytest.fixture(scope="module")
def jax_ref():
    from srbd_nmpc_tpu.models import merit_pallas

    params, weights, arr = _problem()
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        Ac, bc = jsrbd.constraint_matrix(params)
        th, ph = merit_pallas.merit_alpha_pallas(
            params, weights.Q, weights.Qf, weights.R, Ac, bc,
            *(jnp.asarray(arr[k]) for k in ORDER), MU_B, THETA_B, block=8)
        return params, weights, arr, (np.asarray(th), np.asarray(ph))
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("i,name", [(0, "theta"), (1, "phi")])
def test_plain_matches_jax_kernel(jax_ref, i, name):
    params, weights, arr, ref = jax_ref
    before = dict(merit_kernel.launches)
    got = merit_kernel.merit_alpha(*_port(params, weights, arr))
    assert merit_kernel.launches == before   # CPU tensors: the plain version
    np.testing.assert_allclose(got[i].numpy(), ref[i], rtol=1e-12,
                               err_msg=name)


K7B_OUT = ("theta", "phi", "Jphi_x", "Jphi_u", "max_defect", "min_con")


@pytest.mark.parametrize("with_grad", [True, False])
def test_k7b_plain_matches_jax_kernel(jax_ref_k7b, with_grad):
    params, weights, arr, outs = jax_ref_k7b
    args = _port(params, weights, arr)
    before = dict(merit_kernel.launches)
    got = merit_kernel.merit(*args[:9], MU_B, THETA_B, with_grad=with_grad)
    assert merit_kernel.launches == before   # CPU tensors: the plain version
    for name, g, r in zip(K7B_OUT, got, outs[with_grad]):
        if r is None:
            assert g is None and not with_grad, name
            continue
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-13,
                                   err_msg=name)


@pytest.mark.parametrize("with_grad", [True, False])
def test_k7b_cuda_source_host_build_matches_plain(with_grad):
    """K7b's per-scenario body (csrc/merit.cu, both template variants)
    compiled as host C++ in double precision reproduces the plain version:
    the four diagnostics and the N running gradient rows (the terminal row
    is the wrapper's)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    params, weights, arr = _problem(seed=2)
    arr["x"][2, 3, 5] = np.nan      # a NaN scenario stays NaN in both
    tp, Q, Qf, R, Ac, bc, x, u, xr = _port(params, weights, arr)[:9]
    ref = merit_kernel.merit_ref(tp, Q, Qf, R, Ac, bc, x, u, xr, MU_B,
                                 THETA_B, with_grad=with_grad)
    lib = ctypes.CDLL(build.build_host(
        f"{build.CSRC}/merit.cu", flags=("-O2", "-ffp-contract=off")))
    fn = lib.srbd_merit_host_f64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
        [ctypes.c_double] * 2 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    consts = torch.cat([srbd_linearize.model_constants(tp), Ac.reshape(-1),
                        bc, R.reshape(-1), Q.reshape(-1), Qf.reshape(-1)])
    out = torch.empty((4, B), dtype=F64)
    Jx = torch.zeros((N + 1, 12, B), dtype=F64)
    Ju = torch.zeros((N, 12, B), dtype=F64)
    assert fn(consts.data_ptr(), x.data_ptr(), u.data_ptr(), xr.data_ptr(),
              out.data_ptr(), Jx.data_ptr(), Ju.data_ptr(), N, B, MU_B,
              THETA_B, int(with_grad)) == 0
    for i, j in ((0, 0), (1, 1), (2, 4), (3, 5)):
        np.testing.assert_allclose(out[i].numpy(), ref[j].numpy(), rtol=1e-12,
                                   err_msg=K7B_OUT[j])
    assert np.isnan(out[0, 5].item()) and np.isnan(ref[0][5].item())
    if with_grad:
        np.testing.assert_allclose(Jx[:N].numpy(), ref[2][:N].numpy(),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(Ju.numpy(), ref[3].numpy(), rtol=1e-12,
                                   atol=1e-13)
    else:
        assert not Jx.any() and not Ju.any()   # nothing written
