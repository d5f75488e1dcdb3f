"""PyTorch port of the fused SQP trip (kernel K1): the plain version vs the
JAX ``sqp_qp_solve_onepass_planes`` in interpret mode, f64; and the CUDA
source's per-scenario arithmetic, built as host C++ in f64, vs the plain
version.

One JAX call per horizon covers both cases: lanes are independent (no op
crosses scenarios), so lanes 0-7 carry the bootstrap case (alpha = 0,
zero dxc/duc) and lanes 8-15 the candidate case (random alpha in
[0.25, 0.75]), each an 8-scenario batch of its own."""

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
from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.ops import sqp_planes, sqp_stage
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64 = torch.float64
MU_B, THETA_B, REG = 0.1, 5.0, 1e-9
CASES = {"alpha0": slice(0, 8), "alpha": slice(8, 16)}


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield
    monkeypatch.undo()


def _problem(N, seed=0):
    """numpy inputs (as tests/test_sqp_planes.py:_setup), 16 lanes."""
    dtype = jnp.float64
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=dtype)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, dtype)
    x0, x_ref = jengine.make_benchmark_problem(jengine.NmpcConfig(N=N), dtype)
    rng = np.random.default_rng(seed)
    B = 16
    arr = dict(
        xa=rng.normal(size=(N + 1, 12, B)) * 0.3,
        us=rng.normal(size=(N, 12, B)) * 30 + 80,
        xra=np.broadcast_to(np.asarray(x_ref)[:, :, None], (N + 1, 12, B)).copy(),
        x0s=np.asarray(x0)[:, None] + 0.01 * rng.normal(size=(12, B)),
        dxc=rng.normal(size=(N + 1, 12, B)) * 0.05,
        duc=rng.normal(size=(N, 12, B)) * 2.0,
        alpha=0.25 + 0.5 * rng.random(B),
    )
    arr["dxc"][..., :8] = 0.0
    arr["duc"][..., :8] = 0.0
    arr["alpha"][:8] = 0.0
    return params, weights, arr


_ORDER = ("xa", "us", "xra", "dxc", "duc", "alpha", "x0s")


def _port_args(params, weights, arr, lanes=slice(None)):
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name))
         for f in dataclasses.fields(params)}, dtype=F64, device="cpu")
    tw = convert.weights_from_numpy(
        {f.name: np.asarray(getattr(weights, f.name))
         for f in dataclasses.fields(weights)}, dtype=F64, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    data = [torch.as_tensor(np.ascontiguousarray(arr[k][..., lanes]))
            for k in _ORDER]
    return (tp, tw.Q, tw.Qf, tw.R, Ac, bc, *data, MU_B, THETA_B)


@pytest.fixture(scope="module")
def jax_refs():
    """One interpret-mode JAX call per horizon, 16 lanes each."""
    from srbd_nmpc_tpu.ops import sqp_planes as jsp

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = {}
        for N in (5, 20):
            params, weights, arr = _problem(N)
            Ac, bc = jsrbd.constraint_matrix(params)
            res = jsp.sqp_qp_solve_onepass_planes(
                params, weights.Q, weights.Qf, weights.R, Ac, bc,
                *(jnp.asarray(arr[k]) for k in _ORDER), MU_B, THETA_B,
                reg=REG, block=16)
            out[N] = (params, weights, arr, jax_np(res))
        return out
    finally:
        pl.pallas_call = orig


def jax_np(res):
    dx, du, dphi, aux = res
    return (np.asarray(dx), np.asarray(du), np.asarray(dphi),
            tuple(np.asarray(a) for a in aux))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_plain_matches_jax_kernel(jax_refs, N, case):
    params, weights, arr, ref = jax_refs[N]
    lanes = CASES[case]
    before = sqp_planes.launches
    dx, du, dphi, aux = sqp_planes.sqp_qp_solve_onepass_planes(
        *_port_args(params, weights, arr, lanes), reg=REG)
    assert sqp_planes.launches == before   # CPU tensors: the plain version
    np.testing.assert_allclose(dx.numpy(), ref[0][..., lanes],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(du.numpy(), ref[1][..., lanes],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dphi.numpy(), ref[2][lanes],
                               rtol=1e-9, atol=1e-9)
    for got, r in zip(aux, ref[3]):
        np.testing.assert_allclose(got.numpy(), r[lanes], rtol=1e-9,
                                   atol=1e-11)


def test_non_leg_block_diagonal_constraints_raise():
    params, weights, arr = _problem(5)
    args = list(_port_args(params, weights, arr))
    Ac = args[4].clone()
    Ac[0, 7] = 0.5
    args[4] = Ac
    with pytest.raises(ValueError, match="leg-block-diagonal"):
        sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=REG)


@pytest.mark.parametrize("flag", ["rank6", "factor"])
def test_variants_not_ported_raise(flag):
    params, weights, arr = _problem(5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sqp_planes.sqp_qp_solve_onepass_planes(
            *_port_args(params, weights, arr), reg=REG, **{flag: True})


@pytest.mark.parametrize("N", [5, 20])
def test_cuda_source_host_build_matches_plain(N):
    """The kernel's per-scenario body (csrc/sqp_planes.cu) compiled as host
    C++ in double precision reproduces the plain version: it checks the
    hand-written arithmetic of K1 without a card (the CUDA launch itself
    is checked on the card by test_torch_kernels_cuda.py)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    params, weights, arr = _problem(N, seed=1)
    args = _port_args(params, weights, arr)
    tp, Q, Qf, R, Ac, bc, xa, us, xra, dxc, duc, alpha, x0s = args[:13]
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=REG)

    lib = ctypes.CDLL(build.build_host(
        f"{build.CSRC}/sqp_planes.cu", flags=("-O2", "-ffp-contract=off")))
    fn = lib.srbd_sqp_planes_host_f64
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 2
                   + [ctypes.c_double] * 3)
    fn.restype = ctypes.c_int
    Ac1, Ac2 = Ac[0:12, 0:6], Ac[12:24, 6:12]
    consts = torch.cat([tp.mass.reshape(1), tp.dt.reshape(1),
                        tp.inertia_inv.reshape(9), tp.foot_pos.reshape(6),
                        Ac1.reshape(72), Ac2.reshape(72), bc.reshape(24),
                        R.reshape(144), Q.reshape(144), Qf.reshape(144)])
    assert consts.numel() == sqp_stage.K_LEN
    B = xa.shape[-1]
    dx = torch.empty((N + 1, 12, B), dtype=F64)
    dx[0] = x0s - (xa[0] + alpha[None] * dxc[0])
    du = torch.empty((N, 12, B), dtype=F64)
    out5 = torch.empty((5, B), dtype=F64)
    pack = torch.empty((N, sqp_planes._C, B), dtype=F64)
    K = torch.empty((N, 12, 12, B), dtype=F64)
    kv = torch.empty((N, 12, B), dtype=F64)
    ptrs = [t.data_ptr() for t in (consts, xa, us, xra, dxc, duc, alpha, dx,
                                   dx[1:], du, out5[0], out5[1], out5[2],
                                   out5[3], out5[4], pack, K, kv)]
    assert fn(*ptrs, N, B, MU_B, THETA_B, REG) == 0
    np.testing.assert_allclose(dx.numpy(), ref[0].numpy(), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(du.numpy(), ref[1].numpy(), rtol=1e-12,
                               atol=1e-11)
    np.testing.assert_allclose(out5[0].numpy(), ref[2].numpy(), rtol=1e-12)
    for i in range(4):
        np.testing.assert_allclose(out5[1 + i].numpy(), ref[3][i].numpy(),
                                   rtol=1e-12, atol=1e-13)
