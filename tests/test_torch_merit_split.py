"""K7a's line-search merit as a stage pass and a reduction in stage order
(``csrc/merit.cu``: ``k7s_stage_kernel``, one thread per (stage, lane) and
a terminal row, writing [3N + 1, B] terms; ``k7s_reduce_kernel``, one thread
per lane), built as host C++:

- in f64 against the plain ``merit_kernel.merit_alpha_ref`` (rtol = atol =
  1e-12) at N = 1, 5 and 20 on a ragged width, a NaN lane included;
- in f32 (``-DSRBD_HOST_F32``) against stored digests of theta and phi as
  the one-thread body that the two launches replaced gave them;

and the card-only entry ``_merit_alpha_cuda`` raising on what it cannot
take. The launches are checked on the card by
``test_torch_kernels_cuda.py``."""

import ctypes
import functools
import hashlib
import shutil

import numpy as np
import pytest
import torch

from srbd_nmpc_tpu_torch.models import merit_kernel, srbd, srbd_linearize
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
MU_B, THETA_B = 0.1, 5.0
HOST = ("-O2", "-ffp-contract=off")
# a width that is no multiple of the card's 128-lane blocks
B_RAGGED = 133
# sha256 of the one-thread body's f32 host outputs (theta, phi) on
# _problem(20, B_RAGGED, 3) in f32, as built before its stage code was shared
# with the stage pass
ONE_THREAD_F32_DIGEST = (
    "feb0d7c56307507334c8def96189099ce9080cbea2ec40ba796becb0c88ed56f")
# the same on _problem(N, B_RAGGED, 2) in f32, by N
F32_DIGEST = {
    1: "93585b8b5c788a310e4cee14d0b68d7fcb1c0ee6b14f13ebe307e66ad03fd16d",
    5: "91a1bf6bb19d15f8e35158f73e70064e7c2c6c2ed19b7f3625a7b7682d9489be",
    20: "f6ee3f208d57752559080aa09fc2ba63289afe8359f6303a8c44fe2ae238183c",
}


def _problem(N, B, seed, dtype=F64):
    """merit_alpha's arguments: random trajectories x [N+1,12,B] and
    u [N,12,B] around the standing force, a random direction, alpha in
    [0, 1) with lanes at 0 and 1, a row in the barrier's quadratic branch
    and a NaN state in lane 2."""
    params = srbd.SRBDParams.create(dt=0.015, dtype=F64, device="cpu")
    weights = engine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, F64,
        device="cpu")
    Ac, bc = srbd.constraint_matrix(params)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N + 1, 12, B)) * 0.3
    u = rng.normal(size=(N, 12, B)) * 30 + 80
    xr = rng.normal(size=(N + 1, 12, B)) * 0.1
    dx = rng.normal(size=(N + 1, 12, B)) * 0.05
    du = rng.normal(size=(N, 12, B)) * 2.0
    alpha = rng.random(B)
    alpha[0], alpha[1] = 0.0, 1.0
    u[0, 0:3, 1] = -5.0
    x[N // 2, 4, 2] = np.nan

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return (params, weights.Q, weights.Qf, weights.R, Ac, bc, T(x), T(u),
            T(xr), T(dx), T(du), T(alpha), MU_B, THETA_B)


@functools.lru_cache(maxsize=None)
def _lib(f32: bool) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = HOST + (("-DSRBD_HOST_F32",) if f32 else ())
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/merit.cu", flags=flags))
    fn = lib.srbd_merit_alpha_split_host
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                   + [ctypes.c_double] * 2)
    fn.restype = ctypes.c_int
    return lib


def _host(args):
    """(theta, phi) of the host build (the stage pass and the reduction) in
    the inputs' dtype."""
    params, Q, Qf, R, Ac, bc, x, u, xr, dx, du, alpha = args[:12]
    dtype = x.dtype
    N, B = u.shape[0], x.shape[-1]
    consts = torch.cat([srbd_linearize.model_constants(params),
                        Ac.reshape(-1), bc, R.reshape(-1), Q.reshape(-1),
                        Qf.reshape(-1)]).to(dtype)
    out = torch.empty((2, B), dtype=dtype)
    ptrs = [consts.data_ptr(),
            *(t.data_ptr() for t in (x, dx, u, du, xr, alpha)),
            out[0].data_ptr(), out[1].data_ptr()]
    fn = _lib(dtype == F32).srbd_merit_alpha_split_host
    assert fn(*ptrs, N, B, MU_B, THETA_B) == 0
    return out[0], out[1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == F32 else torch.int64)


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("N", [1, 5, 20])
def test_split_host_build_matches_plain(N):
    """The stage pass and the reduction in double precision reproduce the
    plain version, NaN for NaN."""
    args = _problem(N, B_RAGGED, seed=1)
    ref = merit_kernel.merit_alpha_ref(*args)
    for name, g, r in zip(("theta", "phi"), _host(args), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
        assert bool(torch.isnan(g[2])) and bool(torch.isnan(r[2])), name


@pytest.mark.parametrize("N", [1, 5, 20])
def test_split_f32_host_build_rounds_as_one_thread_body(N):
    """In float32 the two passes give the one-thread body's theta and phi
    bit for bit (its stored digests)."""
    outs = _host(_problem(N, B_RAGGED, seed=2, dtype=F32))
    assert torch.isfinite(outs[1][3:]).all()
    assert _digest(outs) == F32_DIGEST[N]


def test_one_thread_f32_host_build_matches_stored_digest():
    """The f32 host outputs are those of the one-thread body as it was
    before its stage code became the shared helper."""
    assert (_digest(_host(_problem(20, B_RAGGED, 3, F32)))
            == ONE_THREAD_F32_DIGEST)


@pytest.mark.parametrize("case", ["cpu", "float64", "misshapen"])
def test_card_entry_raises_on_what_it_cannot_take(case):
    """The card-only entry raises on CPU tensors, on float64 and on
    misshapen inputs before anything is built."""
    dtype = F64 if case == "float64" else F32
    args = list(_problem(5, 16, seed=0, dtype=dtype))
    if case == "misshapen":
        args[6] = args[6][:, :-1].contiguous()    # x with 11 rows
    err = ValueError if case == "misshapen" else TypeError
    with pytest.raises(err, match="shape" if case == "misshapen" else "CUDA"):
        merit_kernel._merit_alpha_cuda(*args)


def test_public_entry_on_cpu_takes_consts_and_runs_the_plain_version():
    """A caller that built the constants block once (the engine, per solve)
    passes it as ``consts=``; on CPU tensors the public entry runs the plain
    version all the same and launches nothing."""
    args = _problem(5, 16, seed=0)
    kc = merit_kernel.kernel_constants(*args[:6])
    before = merit_kernel.launches["merit_alpha"]
    got = merit_kernel.merit_alpha(*args, consts=kc)
    assert merit_kernel.launches["merit_alpha"] == before
    for g, r in zip(got, merit_kernel.merit_alpha_ref(*args)):
        assert torch.equal(_bits(g), _bits(r))
