"""K5's stage linearization as a stage pass and a block-written dense A, B,
R_eff (``csrc/linearize.cu``: ``k5s_stage_kernel`` and ``k5s_dense_kernel``,
two launches through a [N, 24, B] hand-off), built as host C++:

- in f64 against the plain ``srbd_linearize.linearize_ref`` (rtol = atol =
  1e-12) at N = 1, 5 and 20 on a ragged width, a NaN lane included;
- in f32 (``-DSRBD_HOST_F32``) against stored digests of all seven outputs
  of the one-thread body that the two launches replaced, NaN payloads
  included;

and the card-only entry ``_linearize_cuda`` raising on what it cannot take.
The launches are checked on the card by ``test_torch_kernels_cuda.py``."""

import ctypes
import functools
import hashlib
import shutil

import numpy as np
import pytest
import torch

from srbd_nmpc_tpu_torch.models import srbd, srbd_linearize
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
MU_B, THETA_B = 0.1, 5.0
NAMES = ("A", "B", "b", "q", "r_eff", "R_eff", "mer")
# the C entries take (A, B, b, R_eff, r_eff, q, mer)
C_ORDER = (0, 1, 2, 5, 4, 3, 6)
HOST = ("-O2", "-ffp-contract=off")
# a width that is no multiple of the card's 128-lane blocks
B_RAGGED = 133
# sha256 of the one-thread body's f32 host outputs (A, B, b, q, r_eff,
# R_eff, mer) on _problem(20, B_RAGGED, 3) in f32, as built before its stage
# code was shared with the two launches
ONE_THREAD_F32_DIGEST = (
    "ab0c1280d635fa37c1a5b8502785e2e89b04884b5dfdb3c46a2317c2599c8b7e")
# the same on _problem(N, B_RAGGED, 2) in f32, by N
F32_DIGEST = {
    1: "03e6d8eb0c3fde3c1046195391e2fe5ba126403e438e81ed411c3a9314e4279e",
    5: "90adfa03b530f44aa919f38c9324143ed2c282d437a14de7038765600f8120e5",
    20: "eca178381b9d1b7b563400762be4edec4575e3557965da1aaff1711ffb284993",
}


def _problem(N, B, seed, dtype=F64):
    """Parameters and the four stage-major inputs [N, 12, B] (x, x_next,
    u, x_ref): random states with a clamped small angle, inputs around the
    standing force with a row in the barrier's quadratic branch, and a NaN
    state in lane 2 (a stage and its predecessor)."""
    params = srbd.SRBDParams.create(dt=0.015, dtype=F64, device="cpu")
    weights = engine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, F64,
        device="cpu")
    Ac, bc = srbd.constraint_matrix(params)
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(N + 1, 12, B)) * 0.3
    xa[0, 0:3, 0] = 0.0
    us = rng.normal(size=(N, 12, B)) * 30 + 80
    us[0, 0:3, 1] = -5.0
    xr = rng.normal(size=(N, 12, B)) * 0.1
    xa[N // 2 + 1, 4, 2] = np.nan

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return (params, weights.Q, weights.R, Ac, bc, T(xa[:-1]), T(xa[1:]),
            T(us), T(xr), MU_B, THETA_B)


@functools.lru_cache(maxsize=None)
def _lib(f32: bool) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = HOST + (("-DSRBD_HOST_F32",) if f32 else ())
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/linearize.cu",
                                       flags=flags))
    fn = lib.srbd_linearize_split_host
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
                   + [ctypes.c_double] * 2)
    fn.restype = ctypes.c_int
    return lib


def _host(args):
    """The seven outputs of the host build (the stage pass, then the dense
    write) in the inputs' dtype."""
    params, Q, R, Ac, bc, xs, xn, us, xr = args[:9]
    dtype = xs.dtype
    N, _, B = xs.shape
    consts = torch.cat([srbd_linearize.model_constants(params),
                        Ac.reshape(-1), bc, R.reshape(-1),
                        Q.reshape(-1)]).to(dtype)
    outs = [torch.empty((N, 12, 12, B), dtype=dtype) for _ in range(2)]
    outs += [torch.empty((N, 12, B), dtype=dtype) for _ in range(3)]
    outs += [torch.empty((N, 12, 12, B), dtype=dtype),
             torch.empty((N, 8, B), dtype=dtype)]
    ptrs = [consts.data_ptr(), *(t.data_ptr() for t in (xs, xn, us, xr)),
            *(outs[k].data_ptr() for k in C_ORDER)]
    fn = _lib(dtype == F32).srbd_linearize_split_host
    assert fn(*ptrs, N, B, MU_B, THETA_B) == 0
    return outs


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == F32 else torch.int64)


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("N", [1, 5, 20])
def test_design_host_build_matches_plain(N):
    """The two launches in double precision reproduce the plain version on
    all seven outputs, NaN for NaN."""
    args = _problem(N, B_RAGGED, seed=1)
    ref = srbd_linearize.linearize_ref(*args)
    for name, g, r in zip(NAMES, _host(args), ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("N", [1, 5, 20])
def test_design_f32_host_build_rounds_as_one_thread_body(N):
    """In float32 the two launches give the one-thread body's seven outputs
    bit for bit (its stored digests), NaN payloads included."""
    outs = _host(_problem(N, B_RAGGED, seed=2, dtype=F32))
    assert torch.isfinite(outs[5][:, :, :, 3:]).all()  # R_eff off the NaN lane
    assert _digest(outs) == F32_DIGEST[N]


def test_one_thread_f32_host_build_matches_stored_digest():
    """The f32 host outputs are those of the one-thread body as it was
    before its stage code became the shared helpers."""
    outs = _host(_problem(20, B_RAGGED, 3, F32))
    assert _digest(outs) == ONE_THREAD_F32_DIGEST


@pytest.mark.parametrize("case", ["cpu", "float64", "misshapen"])
def test_card_entry_raises_on_what_it_cannot_take(case):
    """The card-only entry raises on CPU tensors, on float64 and on
    misshapen inputs before anything is built."""
    dtype = F64 if case == "float64" else F32
    args = list(_problem(5, 16, seed=0, dtype=dtype))
    if case == "misshapen":
        args[5] = args[5][:, :-1].contiguous()    # x with 11 rows
    err = ValueError if case == "misshapen" else TypeError
    with pytest.raises(err, match="shape" if case == "misshapen" else "CUDA"):
        srbd_linearize._linearize_cuda(*args)


def test_public_entry_on_cpu_takes_consts_and_runs_the_plain_version():
    """A caller that built the constants block once (the engine, per solve)
    passes it as ``consts=``; on CPU tensors the public entry runs the plain
    version all the same and launches nothing."""
    args = _problem(5, 16, seed=0)
    kc = srbd_linearize.kernel_constants(*args[:5])
    before = srbd_linearize.launches
    got = srbd_linearize.linearize(*args, consts=kc)
    assert srbd_linearize.launches == before
    for g, r in zip(got, srbd_linearize.linearize_ref(*args)):
        assert torch.equal(_bits(g), _bits(r))
