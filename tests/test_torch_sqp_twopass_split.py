"""K4a, the two-pass solve's backward kernel, as four launches
(``ops/sqp_kernel._k4a_launches``): K5's stage pass and dense write
(``csrc/linearize.cu``), the terminal-and-merit pass (``csrc/sqp_twopass.cu``
``k4s_merit_kernel``) and K6a's team pass also writing Acl and bcl
(``csrc/riccati.cu`` ``riccati_team_acl_kernel``), each built as host C++
and run in that order, the team's members one after another within each
step:

- in f64 against the plain ``sqp_kernel.sqp_qp_backward_ref`` (rtol 1e-10,
  atol 1e-12) on all eleven outputs, at N = 5 and 20 and the emulated team
  widths 8, 16 (the card's) and 32;
- in f32 (``-DSRBD_HOST_F32``) against stored digests of the eleven
  outputs of the one-thread body that the four launches replaced, at each
  width in either member order (N = 20) and at the card's (N = 5);
- in f64 against JAX's ``sqp_pallas.sqp_qp_solve`` backward outputs in
  interpret mode, at ``test_torch_sqp_kernel.py``'s tolerance;

and the card-only entry ``_k4a_cuda`` raising on what it cannot take. The launches are checked on the card by
``test_torch_kernels_cuda.py``."""

import ctypes
import dataclasses
import functools
import hashlib
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
from srbd_nmpc_tpu_torch.ops import sqp_kernel
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
MU_B, THETA_B, REG = 0.1, 5.0, 1e-9
B = 16
# team widths to emulate: the card's (16) and two more, since the rounding
# must not depend on how a stage's work items fall to the members
TEAMS = (8, 16, 32)
NAMES = ("Acl", "K", "bcl", "kv", "q", "reff", "qN",
         "theta", "phi", "maxdef", "mincon")
# sha256 of the eleven f32 host outputs on _problem(N, seed=3) in f32, by N,
# as the one-thread body that the four launches replaced gave them
F32_DIGEST = {
    20: "8b4dfb38f723aea3147cb5f33c7a61f9cfe46aad2f89fad411ec3fc51ad7efea",
    5: "b361c68a2579a1c3307fa2b48cbbf823bd3a9c47b1e1aca9c94f0403806a8dc2",
}


def _problem(N, seed=0, Bt=B):
    """JAX parameters and weights and numpy inputs as
    tests/test_sqp_pallas.py:_setup: random trajectories around the cold
    start, the benchmark reference."""
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=jnp.float64)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, jnp.float64)
    _, x_ref = jengine.make_benchmark_problem(jengine.NmpcConfig(N=N),
                                              jnp.float64)
    rng = np.random.default_rng(seed)
    arr = dict(
        xa=rng.normal(size=(N + 1, 12, Bt)) * 0.3,
        us=rng.normal(size=(N, 12, Bt)) * 30 + 80,
        xra=np.broadcast_to(np.asarray(x_ref)[:, :, None],
                            (N + 1, 12, Bt)).copy())
    return params, weights, arr


def _port_args(params, weights, arr, dtype=F64):
    """sqp_qp_backward's arguments in the port, the arrays in ``dtype``."""
    def d(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    tp = convert.params_from_numpy(d(params), dtype=dtype, device="cpu")
    tw = convert.weights_from_numpy(d(weights), dtype=dtype, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    data = [torch.as_tensor(arr[k], dtype=dtype).contiguous()
            for k in ("xa", "us", "xra")]
    return (tp, tw.Q, tw.Qf, tw.R, Ac, bc, *data, MU_B, THETA_B)


@functools.lru_cache(maxsize=None)
def _libs(f32: bool):
    """The host builds of linearize.cu, sqp_twopass.cu and riccati.cu."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = ("-O2", "-ffp-contract=off") + (("-DSRBD_HOST_F32",) if f32 else ())
    lin, two, ric = (ctypes.CDLL(build.build_host(f"{build.CSRC}/{n}.cu",
                                                  flags=flags))
                     for n in ("linearize", "sqp_twopass", "riccati"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lin.srbd_linearize_split_host.argtypes = [P] * 12 + [I, I, D, D]
    two.srbd_k4s_merit_host.argtypes = [P] * 9 + [I, I]
    ric.srbd_riccati_bwd_team_acl_host.argtypes = [I, I] + [P] * 11 + [I, I, D]
    for fn in (lin.srbd_linearize_split_host, two.srbd_k4s_merit_host,
               ric.srbd_riccati_bwd_team_acl_host):
        fn.restype = ctypes.c_int
    return lin, two, ric


def _consts(args, dtype):
    """K4a's constants block (``sqp_kernel._k4_constants``' layout); its
    first 617 words are K5's."""
    tp, Q, Qf, R, Ac, bc = args[:6]
    return torch.cat([t.reshape(-1) for t in (model_constants(tp), Ac, bc, R,
                                              Q, Qf)]).to(dtype).contiguous()


def _host_split(args, team, rev=False):
    """The four launches' host builds in the card's order on every lane of
    ``args`` (its dtype: f64, or f32 for the f32 builds): the eleven
    outputs of ``sqp_qp_backward_ref``."""
    xa, us, xra = args[6:9]
    dtype = xa.dtype
    lin, two, ric = _libs(dtype == F32)
    N, Bt = us.shape[0], xa.shape[-1]
    consts = _consts(args, dtype)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype)

    A, Bm, Reff = (empty(N, 12, 12, Bt) for _ in range(3))
    b, reff, mer, q = (empty(N, 12, Bt), empty(N, 12, Bt), empty(N, 8, Bt),
                       empty(N + 1, 12, Bt))
    assert lin.srbd_linearize_split_host(
        *(t.data_ptr() for t in (consts, xa, xa[1:], us, xra, A, Bm, b, Reff,
                                 reff, q, mer)), N, Bt, MU_B, THETA_B) == 0
    out4 = empty(4, Bt)
    assert two.srbd_k4s_merit_host(
        *(t.data_ptr() for t in (consts, xa, xra, mer, q, *out4)), N, Bt) == 0
    Acl, K = empty(N, 12, 12, Bt), empty(N, 12, 12, Bt)
    bcl, kv = empty(N, 12, Bt), empty(N, 12, Bt)
    assert ric.srbd_riccati_bwd_team_acl_host(
        team, int(rev), *(t.data_ptr() for t in (
            A, Bm, b, consts[473:761], Reff, q, reff, K, kv, Acl, bcl)),
        N, Bt, REG) == 0
    return (Acl, K, bcl, kv, q[:N], reff, q[N], *out4)


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _f32_digest(N, team, rev) -> str:
    params, weights, arr = _problem(N, seed=3)
    return _digest(_host_split(_port_args(params, weights, arr, F32), team,
                               rev))


def _flat(ref):
    return (*ref[:7], *ref[7])


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("N", [5, 20])
def test_split_host_build_matches_plain(N, team):
    """The four launches' arithmetic compiled as host C++ in double
    precision reproduces the plain K4a on all eleven outputs, with K6a's
    team at each emulated width."""
    params, weights, arr = _problem(N, seed=N)
    args = _port_args(params, weights, arr)
    ref = _flat(sqp_kernel.sqp_qp_backward_ref(*args, reg=REG))
    got = _host_split(args, team)
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
def test_split_f32_host_build_rounds_as_one_thread_body(team, rev):
    """In float32, the four launches give the one-thread body's eleven
    outputs bit for bit (its stored digests), with either member order of
    K6a's team: the linearization, the Riccati stage, Acl = A + B K and
    bcl = b + B kv round as that body's, and the merit is accumulated in its
    stage order and grouping."""
    assert _f32_digest(20, team, rev) == F32_DIGEST[20]


@pytest.mark.parametrize("rev", [False, True])
def test_split_f32_host_build_matches_digest_at_n5(rev):
    """The same at N = 5, at the card's team width in either member
    order."""
    assert _f32_digest(5, 16, rev) == F32_DIGEST[5]


def test_split_host_build_matches_jax_kernel():
    """The f64 host build of the four launches against the backward outputs
    of JAX's ``sqp_pallas.sqp_qp_solve`` (its first ``pallas_call``,
    ``_bwd_kernel``, in interpret mode), at the tolerance
    ``test_torch_sqp_kernel.py`` holds the plain version to."""
    from srbd_nmpc_tpu.ops import sqp_pallas

    N, Bt = 6, 8
    params, weights, arr = _problem(N, seed=0, Bt=Bt)
    Ac, bc = jsrbd.constraint_matrix(params)
    seen = []
    orig = pl.pallas_call

    def capture(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def run(*a):
            out = call(*a)
            if getattr(kernel, "func", None) is sqp_pallas._bwd_kernel:
                seen.append(out)
            return out
        return run

    pl.pallas_call = capture
    try:
        sqp_pallas.sqp_qp_solve(
            params, weights.Q, weights.Qf, weights.R, Ac, bc,
            *(jnp.asarray(arr[k]) for k in ("xa", "us", "xra")),
            jnp.zeros((12, Bt)), MU_B, THETA_B, reg=REG, block=Bt)
    finally:
        pl.pallas_call = orig
    (ref,) = seen
    got = _host_split(_port_args(params, weights, arr), 16)
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(g.shape),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_card_entry_raises_on_what_it_cannot_take(dtype):
    """The card-only entry of K4a raises on CPU tensors (float64 or
    float32), and on a misshapen input on any device, before anything is
    built."""
    params, weights, arr = _problem(5)
    args = list(_port_args(params, weights, arr, dtype))
    with pytest.raises(TypeError, match="CUDA"):
        sqp_kernel._k4a_cuda(*args, reg=REG)
    args[6] = args[6][:-1]                   # xa with N rows, not N + 1
    with pytest.raises(ValueError, match="xa"):
        sqp_kernel._k4a_cuda(*args, reg=REG)
