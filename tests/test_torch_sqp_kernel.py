"""PyTorch port of the dense fused SQP solves (kernels K3a, K3b, K4): each
plain version vs the JAX ``ops/sqp_pallas.py`` function in interpret mode,
f64, B=8, N=6 (rtol 1e-10); and K4's CUDA launches, built as host C++ in
f64, vs the plain versions (rtol 1e-12; K3's launches are held the same
way by test_torch_sqp_onepass_split.py).

The inputs follow tests/test_sqp_pallas.py:_setup: random trajectories
around the cold start, the benchmark reference, a random candidate
direction and a per-scenario alpha in [0.25, 0.75]."""

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
from srbd_nmpc_tpu_torch.models.srbd_linearize import model_constants
from srbd_nmpc_tpu_torch.ops import sqp_kernel, sqp_stage
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64 = torch.float64
MU_B, THETA_B, REG = 0.1, 5.0, 1e-9
B, N = 8, 6
CASES = ("cand_fold", "cand_nofold", "onepass_fold", "onepass_nofold",
         "twopass")


def _problem(seed=0):
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=jnp.float64)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, jnp.float64)
    x0, x_ref = jengine.make_benchmark_problem(jengine.NmpcConfig(N=N),
                                               jnp.float64)
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(N + 1, 12, B)) * 0.3
    arr = dict(
        xa=xa, us=rng.normal(size=(N, 12, B)) * 30 + 80,
        xra=np.broadcast_to(np.asarray(x_ref)[:, :, None], (N + 1, 12, B)).copy(),
        dxc=rng.normal(size=(N + 1, 12, B)) * 0.05,
        duc=rng.normal(size=(N, 12, B)) * 2.0,
        alpha=0.25 + 0.5 * rng.random(B),
        x0s=np.asarray(x0)[:, None] + 0.02 * rng.normal(size=(12, B)))
    arr["dx0"] = arr["x0s"] - xa[0]
    return params, weights, arr


def _args(case, arr, conv):
    keys = (("xa", "us", "xra", "dxc", "duc", "alpha", "x0s")
            if case.startswith("cand") else ("xa", "us", "xra", "dx0"))
    return tuple(conv(arr[k]) for k in keys)


def _port_consts(params, weights):
    def d(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    tp = convert.params_from_numpy(d(params), dtype=F64, device="cpu")
    tw = convert.weights_from_numpy(d(weights), dtype=F64, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    return tp, tw, Ac, bc


def _port_call(case, tp, tw, Ac, bc, arr):
    head = (tp, tw.Q, tw.Qf, tw.R, Ac, bc)
    data = _args(case, arr, torch.as_tensor)
    fold = {"fold": case.endswith("_fold")}
    if case.startswith("cand"):
        return sqp_kernel.sqp_qp_solve_onepass_cand(
            *head, *data, MU_B, THETA_B, reg=REG, **fold)
    if case.startswith("onepass"):
        return sqp_kernel.sqp_qp_solve_onepass(
            *head, *data, MU_B, THETA_B, reg=REG, **fold)
    return sqp_kernel.sqp_qp_solve(*head, *data, MU_B, THETA_B, reg=REG)


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module", params=CASES)
def jax_ref(request, problem):
    from srbd_nmpc_tpu.ops import sqp_pallas

    case = request.param
    params, weights, arr = problem
    Ac, bc = jsrbd.constraint_matrix(params)
    head = (params, weights.Q, weights.Qf, weights.R, Ac, bc)
    data = _args(case, arr, jnp.asarray)
    fold = case.endswith("_fold")
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        if case.startswith("cand"):
            res = sqp_pallas.sqp_qp_solve_onepass_cand(
                *head, *data, MU_B, THETA_B, reg=REG, block=B, fold=fold)
        elif case.startswith("onepass"):
            res = sqp_pallas.sqp_qp_solve_onepass(
                *head, *data, MU_B, THETA_B, reg=REG, block=B, fold=fold)
        else:
            res = sqp_pallas.sqp_qp_solve(*head, *data, MU_B, THETA_B,
                                          reg=REG, block=B)
    finally:
        pl.pallas_call = orig
    dx, du, dphi, aux = res
    return case, (np.asarray(dx), np.asarray(du), np.asarray(dphi),
                  tuple(np.asarray(a) for a in aux))


def test_plain_matches_jax_kernel(problem, jax_ref):
    case, ref = jax_ref
    params, weights, arr = problem
    before = dict(sqp_kernel.launches)
    dx, du, dphi, aux = _port_call(case, *_port_consts(params, weights), arr)
    assert sqp_kernel.launches == before     # CPU tensors: the plain version
    for got, want in ((dx, ref[0]), (du, ref[1]), (dphi, ref[2]),
                      *zip(aux, ref[3])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_onepass_matches_twopass(problem):
    """K3b's structured recursion against K4's dense one, as
    tests/test_sqp_pallas.py::test_sqp_qp_solve_onepass_matches_twopass
    holds the JAX kernels."""
    params, weights, arr = problem
    consts = _port_consts(params, weights)
    one = _port_call("onepass_fold", *consts, arr)
    two = _port_call("twopass", *consts, arr)
    np.testing.assert_allclose(one[0].numpy(), two[0].numpy(), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(one[1].numpy(), two[1].numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(one[2].numpy(), two[2].numpy(), rtol=1e-12,
                               atol=1e-12)
    for a1, a2 in zip(one[3], two[3]):
        np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-12,
                                   atol=1e-13)


def test_non_leg_block_diagonal_constraints_raise(problem):
    params, weights, arr = problem
    tp, tw, Ac, bc = _port_consts(params, weights)
    Ac = Ac.clone()
    Ac[0, 7] = 0.5
    for case in ("cand_fold", "onepass_fold"):
        with pytest.raises(ValueError, match="leg-block-diagonal"):
            _port_call(case, tp, tw, Ac, bc, arr)
    with pytest.raises(ValueError, match="leg-block-diagonal"):
        sqp_stage.kernel_constants(tp, tw.Q, tw.Qf, tw.R, Ac, bc)


def _host(name):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    return ctypes.CDLL(build.build_host(f"{build.CSRC}/{name}.cu",
                                        flags=("-O2", "-ffp-contract=off")))


def _f64(*shape):
    return torch.empty(shape, dtype=F64)


def test_twopass_source_host_build_matches_plain(problem):
    """K4a's four launches (csrc/linearize.cu's two, csrc/sqp_twopass.cu's
    terminal-and-merit pass, csrc/riccati.cu's team pass with Acl and bcl,
    at the card's team width) and K4b (csrc/sqp_twopass.cu) as host C++ in
    f64 against the plain versions."""
    params, weights, arr = problem
    tp, tw, Ac, bc = _port_consts(params, weights)
    xa, us, xra, dx0 = (torch.as_tensor(arr[k])
                        for k in ("xa", "us", "xra", "dx0"))
    ref_b = sqp_kernel.sqp_qp_backward_ref(tp, tw.Q, tw.Qf, tw.R, Ac, bc, xa,
                                           us, xra, MU_B, THETA_B, REG)
    lin, lib, ric = _host("linearize"), _host("sqp_twopass"), _host("riccati")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    stage, merit = lin.srbd_linearize_split_host, lib.srbd_k4s_merit_host
    team, fwd = ric.srbd_riccati_bwd_team_acl_host, lib.srbd_sqp_twopass_fwd_host_f64
    stage.argtypes = [P] * 12 + [I, I, D, D]
    merit.argtypes = [P] * 9 + [I, I]
    team.argtypes = [I, I] + [P] * 11 + [I, I, D]
    fwd.argtypes = [P] * 11 + [I, I]
    for fn in (stage, merit, team, fwd):
        fn.restype = ctypes.c_int
    consts = torch.cat([t.reshape(-1) for t in (model_constants(tp), Ac, bc,
                                                tw.R, tw.Q, tw.Qf)])
    A, Bm, Reff = _f64(N, 12, 12, B), _f64(N, 12, 12, B), _f64(N, 12, 12, B)
    b, reff, mer, q = _f64(N, 12, B), _f64(N, 12, B), _f64(N, 8, B), \
        _f64(N + 1, 12, B)
    assert stage(*(t.data_ptr() for t in (consts, xa, xa[1:], us, xra, A, Bm,
                                          b, Reff, reff, q, mer)),
                 N, B, MU_B, THETA_B) == 0
    out4 = _f64(4, B)
    assert merit(*(t.data_ptr() for t in (consts, xa, xra, mer, q, *out4)),
                 N, B) == 0
    Acl, K, bcl, kv = _f64(N, 12, 12, B), _f64(N, 12, 12, B), \
        _f64(N, 12, B), _f64(N, 12, B)
    assert team(16, 0, *(t.data_ptr() for t in (
        A, Bm, b, consts[473:].contiguous(), Reff, q, reff, K, kv, Acl,
        bcl)), N, B, REG) == 0
    for got, want in zip((Acl, K, bcl, kv, q[:N], reff, q[N], *out4),
                         (*ref_b[:7], *ref_b[7])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)

    ref_f = sqp_kernel.sqp_qp_forward_ref(*ref_b[:7], dx0)
    dx, du, dphi = _f64(N, 12, B), _f64(N, 12, B), _f64(B)
    assert fwd(*(t.data_ptr() for t in (*ref_b[:7], dx0, dx, du, dphi)),
               N, B) == 0
    for got, want in zip((dx, du, dphi), ref_f):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
