"""K6's team backward pass (``csrc/riccati.cu``: ``riccati_team_kernel``, a
team of threads per scenario over shared memory) built as host C++, each
team's members run one after another within each step:

- in f64 against the plain ``riccati_kernel.lqr_backward_ref`` (rtol 1e-10,
  atol 1e-12, as ``test_torch_riccati_kernel.py`` holds the one-thread
  body), at the emulated team widths 8, 16 (the card's) and 32;
- in f32 (``-DSRBD_HOST_F32``) bit for bit against the one-thread body's f32
  host build, at each width in either member order: no sum is split between
  members or reordered, and no step reads what another member writes in it;

and the card-only entry ``_lqr_backward_cuda`` (team or one-thread kernel)
raising on what it cannot take. The launches are checked on the card by
``test_torch_kernels_cuda.py``."""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from srbd_nmpc_tpu_torch.ops import riccati_kernel
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
B = 16
REG = 1e-9
# team widths to emulate: the card's (16) and two more, since the rounding
# must not depend on how a stage's work items fall to the members
TEAMS = (8, 16, 32)


def _problem(N, seed=0, dtype=torch.float64):
    """As tests/test_riccati_pallas.py:make_problem, at N stages and B
    lanes: (A, B, b, Q [N+1,12,12,B], R, q, r, (Q, Qf))."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: rng.normal(size=s)          # noqa: E731
    A = rnd(N, 12, 12, B) * 0.2 + np.eye(12)[..., None]
    Bm = rnd(N, 12, 12, B) * 0.1
    b = rnd(N, 12, B) * 0.1
    Qh = rnd(N + 1, 12, 12, B)
    Q = np.einsum("nikb,njkb->nijb", Qh, Qh) * 0.1 + np.eye(12)[..., None]
    Rh = rnd(N, 12, 12, B)
    R = np.einsum("nikb,njkb->nijb", Rh, Rh) * 0.1 + np.eye(12)[..., None]
    q = rnd(N + 1, 12, B)
    r = rnd(N, 12, B)
    Qc = (np.diag(rng.random(12) + 0.5), np.diag(rng.random(12) * 10 + 1.0))

    def T(a):
        return torch.as_tensor(a, dtype=dtype).contiguous()

    return (*(T(a) for a in (A, Bm, b, Q, R, q, r)), tuple(T(m) for m in Qc))


@functools.lru_cache(maxsize=None)
def _lib(f32: bool) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = ("-O2", "-ffp-contract=off") + (("-DSRBD_HOST_F32",) if f32 else ())
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/riccati.cu", flags=flags))
    tail = [ctypes.c_int] * 2 + [ctypes.c_double, ctypes.c_int]
    lib.srbd_riccati_bwd_team_host.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + tail)
    lib.srbd_riccati_bwd_host_f64.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.srbd_riccati_bwd_team_host.restype = ctypes.c_int
    lib.srbd_riccati_bwd_host_f64.restype = ctypes.c_int
    return lib


def _host_backward(prob, const_q, team=None, rev=False):
    """(K, k) of the team host build (``team``: the emulated width, ``rev``:
    the members in reverse order), or of the one-thread body's host build
    with ``team=None``, in the problem's dtype."""
    A, Bm, b, Q, R, q, r, Qc = prob
    N, dtype = A.shape[0], A.dtype
    lib = _lib(dtype == torch.float32)
    Qptr = torch.cat([Qc[0].reshape(-1), Qc[1].reshape(-1)]) if const_q else Q
    K = torch.empty((N, 12, 12, B), dtype=dtype)
    k = torch.empty((N, 12, B), dtype=dtype)
    ptrs = [t.data_ptr() for t in (A, Bm, b, Qptr, R, q, r, K, k)]
    if team is None:
        rc = lib.srbd_riccati_bwd_host_f64(*ptrs, N, B, REG, int(const_q))
    else:
        rc = lib.srbd_riccati_bwd_team_host(team, int(rev), *ptrs, N, B, REG,
                                            int(const_q))
    assert rc == 0
    return K, k


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("const_q", [True, False])
@pytest.mark.parametrize("N", [5, 20])
def test_team_host_build_matches_plain(N, const_q, team):
    """The team body in double precision reproduces the plain version, with
    stage-constant (Q, Qf) (K6a) and per-stage Q (K6b)."""
    prob = _problem(N, seed=1)
    A, Bm, b, Q, R, q, r, Qc = prob
    K_ref, k_ref = riccati_kernel.lqr_backward_ref(
        A, Bm, b, Qc if const_q else Q, R, q, r, REG)
    K, k = _host_backward(prob, const_q, team)
    np.testing.assert_allclose(K.numpy(), K_ref.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(k.numpy(), k_ref.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
@pytest.mark.parametrize("const_q", [True, False])
def test_team_f32_host_build_rounds_as_one_thread_body(const_q, team, rev):
    """In float32 the team body gives the one-thread body's K and k bit for
    bit, with either member order of a team."""
    prob = _problem(20, seed=2, dtype=torch.float32)
    K_one, k_one = _host_backward(prob, const_q)
    K, k = _host_backward(prob, const_q, team, rev)
    assert torch.isfinite(K).all() and torch.isfinite(k).all()
    assert torch.equal(K, K_one)
    assert torch.equal(k, k_one)


def test_team_host_build_takes_widths_8_to_32():
    prob = _problem(5)
    A, Bm, b, Q, R, q, r, _ = prob
    K, k = torch.empty((5, 12, 12, B), dtype=torch.float64), \
        torch.empty((5, 12, B), dtype=torch.float64)
    ptrs = [t.data_ptr() for t in (A, Bm, b, Q, R, q, r, K, k)]
    fn = _lib(False).srbd_riccati_bwd_team_host
    assert fn(4, 0, *ptrs, 5, B, REG, 0) == 1
    assert fn(64, 0, *ptrs, 5, B, REG, 0) == 1


@pytest.mark.parametrize("one_thread", [False, True])
@pytest.mark.parametrize("case", ["cpu", "float64", "misshapen"])
def test_card_entry_raises_on_what_it_cannot_take(case, one_thread):
    """The card-only backward entry, team or one-thread kernel, raises on
    CPU tensors, on float64 and on misshapen inputs before anything is
    built (the constant Q and Qf may lie anywhere, so their shape is what
    a CPU call can get wrong)."""
    dtype = torch.float64 if case == "float64" else torch.float32
    A, Bm, b, Q, R, q, r, Qc = _problem(5, dtype=dtype)
    if case == "misshapen":
        Qc = (Qc[0], Qc[1][:, :-1])
    err = ValueError if case == "misshapen" else TypeError
    with pytest.raises(err, match="shape" if case == "misshapen" else "CUDA"):
        riccati_kernel._lqr_backward_cuda(A, Bm, b, Qc, R, q, r, REG,
                                          one_thread=one_thread)
