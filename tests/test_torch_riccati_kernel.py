"""PyTorch port of the ``pallas`` route's LQR solve (kernel K6): the plain
versions vs the JAX ``lqr_solve_pallas`` in interpret mode, f64, with
stage-constant ``(Q, Qf)`` and with per-stage Q; and the CUDA source's
arithmetic (the team backward pass at the card's width, the forward
rollout), built as host C++ in f64, vs the plain versions.

Tolerance: rtol 1e-10 (a Cholesky sits between inputs and outputs)."""

import ctypes
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srbd_nmpc_tpu_torch.ops import riccati_kernel
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
N, B = 5, 16
REG = 1e-9


def _problem(seed=0):
    """As tests/test_riccati_pallas.py:make_problem, f64."""
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
    x0 = rnd(12, B)
    Qs = np.diag(rng.random(12) + 0.5)
    Qf = np.diag(rng.random(12) * 10 + 1.0)
    return A, Bm, b, Q, R, q, r, x0, (Qs, Qf)


def _q(Q, Qc, const_q, lib):
    return tuple(lib(m) for m in Qc) if const_q else lib(Q)


@pytest.fixture(scope="module")
def jax_refs():
    from srbd_nmpc_tpu.ops import riccati_pallas

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = {}
        A, Bm, b, Q, R, q, r, x0, Qc = _problem()
        for const_q in (True, False):
            x, u = riccati_pallas.lqr_solve_pallas(
                *(jnp.asarray(a) for a in (A, Bm, b)),
                _q(Q, Qc, const_q, jnp.asarray),
                *(jnp.asarray(a) for a in (R, q, r, x0)), reg=REG, block=8)
            out[const_q] = (np.asarray(x), np.asarray(u))
        return out
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("const_q", [True, False])
def test_plain_matches_jax_kernel(jax_refs, const_q):
    A, Bm, b, Q, R, q, r, x0, Qc = _problem()
    T = torch.as_tensor
    before = dict(riccati_kernel.launches)
    x, u = riccati_kernel.lqr_solve(T(A), T(Bm), T(b), _q(Q, Qc, const_q, T),
                                    T(R), T(q), T(r), T(x0), reg=REG)
    assert riccati_kernel.launches == before   # CPU: the plain versions
    x_j, u_j = jax_refs[const_q]
    np.testing.assert_allclose(x.numpy(), x_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(u.numpy(), u_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("const_q", [True, False])
def test_cuda_source_host_build_matches_plain(const_q):
    """The kernels' bodies (csrc/riccati.cu: the team backward pass, its
    team of 16 emulated member by member, and the forward rollout) compiled
    as host C++ in double precision reproduce the plain versions; the CUDA
    launches are checked on the card by test_torch_kernels_cuda.py."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    A, Bm, b, Q, R, q, r, x0, Qc = (
        tuple(torch.as_tensor(m) for m in a) if isinstance(a, tuple)
        else torch.as_tensor(a) for a in _problem(seed=1))
    Qarg = Qc if const_q else Q
    K_ref, k_ref = riccati_kernel.lqr_backward_ref(A, Bm, b, Qarg, R, q, r,
                                                   REG)
    x_ref, u_ref = riccati_kernel.lqr_forward_ref(A, Bm, b, K_ref, k_ref, x0)

    lib = ctypes.CDLL(build.build_host(
        f"{build.CSRC}/riccati.cu", flags=("-O2", "-ffp-contract=off")))
    bwd, fwd = lib.srbd_riccati_bwd_team_host, lib.srbd_riccati_fwd_host_f64
    bwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 2 + [ctypes.c_double, ctypes.c_int]
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    bwd.restype = fwd.restype = ctypes.c_int
    Qptr = torch.cat([Qc[0].reshape(-1), Qc[1].reshape(-1)]) if const_q else Q
    K, k = torch.empty_like(K_ref), torch.empty_like(k_ref)
    assert bwd(16, 0, A.data_ptr(), Bm.data_ptr(), b.data_ptr(), Qptr.data_ptr(),
               R.data_ptr(), q.data_ptr(), r.data_ptr(), K.data_ptr(),
               k.data_ptr(), N, B, REG, int(const_q)) == 0
    np.testing.assert_allclose(K.numpy(), K_ref.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(k.numpy(), k_ref.numpy(), rtol=1e-10,
                               atol=1e-12)
    x, u = torch.empty_like(x_ref), torch.empty_like(u_ref)
    assert fwd(A.data_ptr(), Bm.data_ptr(), b.data_ptr(), K_ref.data_ptr(),
               k_ref.data_ptr(), x0.data_ptr(), x.data_ptr(), u.data_ptr(),
               N, B) == 0
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(u.numpy(), u_ref.numpy(), rtol=1e-12,
                               atol=1e-12)
