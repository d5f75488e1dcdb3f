"""The dense one-pass SQP trip (K3a at the candidate, K3b at the iterate) as
three launches (``csrc/sqp_onepass.cu``: the plane pass K3s-A, the team
Riccati pass ``k1s_riccati_team_kernel`` of ``sqp_planes.cu``, the
closed-loop rollout K3s-C), built as host C++ with each team of the Riccati
pass emulated member by member:

- in f64 against the plain versions ``sqp_qp_solve_onepass{,_cand}_ref``
  (rtol = atol = 1e-12), at team widths 8, 16 (the card's) and 32;
- in f32 against stored digests of all seven outputs of the one-thread
  body that the three launches replaced, with the members in either order
  (the plain version in f32 is not bitwise to that body on dx, du and dphi,
  so it cannot serve as the yardstick).

The inputs follow tests/test_sqp_pallas.py:_setup: random trajectories
around the cold start, the benchmark reference, a random candidate
direction and a per-scenario alpha in [0.25, 0.75]."""

import ctypes
import dataclasses
import functools
import hashlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.models import srbd as jsrbd
from srbd_nmpc_tpu.nmpc import engine as jengine
from srbd_nmpc_tpu_torch import convert
from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.ops import sqp_kernel, sqp_planes, sqp_stage
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
MU_B, THETA_B, REG = 0.1, 5.0, 1e-9
B = 16
# team widths of the Riccati pass to emulate: the card's (16) and two more
TEAMS = (8, 16, 32)
HOST = ("-O2", "-ffp-contract=off")
# sha256 of the one-thread body's f32 host outputs (dx, du, dphi, theta,
# phi, maxdef, mincon) on _f32_args(cand), which the three launches give
# bit for bit
ONE_THREAD_F32_DIGEST = {
    True: "8f385294969d518c57f02656043d1340ea38ca9226672e8197fde051494e2825",
    False: "04948c08f28fb05299bd7b04a159ce2aee8cc638d92f55e3094715d509eddf7b",
}


def _problem(N, seed):
    params = jsrbd.SRBDParams.create(dt=0.015, dtype=jnp.float64)
    weights = jengine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, jnp.float64)
    x0, x_ref = jengine.make_benchmark_problem(jengine.NmpcConfig(N=N),
                                               jnp.float64)
    rng = np.random.default_rng(seed)
    arr = dict(
        xa=rng.normal(size=(N + 1, 12, B)) * 0.3,
        us=rng.normal(size=(N, 12, B)) * 30 + 80,
        xra=np.broadcast_to(np.asarray(x_ref)[:, :, None],
                            (N + 1, 12, B)).copy(),
        dxc=rng.normal(size=(N + 1, 12, B)) * 0.05,
        duc=rng.normal(size=(N, 12, B)) * 2.0,
        alpha=0.25 + 0.5 * rng.random(B),
        x0s=np.asarray(x0)[:, None] + 0.02 * rng.normal(size=(12, B)))

    def d(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    tp = convert.params_from_numpy(d(params), dtype=F64, device="cpu")
    tw = convert.weights_from_numpy(d(weights), dtype=F64, device="cpu")
    Ac, bc = srbd.constraint_matrix(tp)
    data = [torch.as_tensor(arr[k]) for k in
            ("xa", "us", "xra", "dxc", "duc", "alpha", "x0s")]
    return (tp, tw.Q, tw.Qf, tw.R, Ac, bc, *data)


def _f32_args(seed=2):
    args = list(_problem(20, seed))
    args[0] = dataclasses.replace(args[0], **{
        f.name: getattr(args[0], f.name).to(F32)
        for f in dataclasses.fields(args[0])})
    return (args[0], *(a.to(F32) for a in args[1:]))


def _consts(tp, Q, Qf, R, Ac, bc, dtype):
    """K3's constants block (``sqp_stage.kernel_constants``' layout)."""
    consts = torch.cat([tp.mass.reshape(1), tp.dt.reshape(1),
                        tp.inertia_inv.reshape(9), tp.foot_pos.reshape(6),
                        Ac[0:12, 0:6].reshape(72), Ac[12:24, 6:12].reshape(72),
                        bc.reshape(24), R.reshape(144), Q.reshape(144),
                        Qf.reshape(144)]).to(dtype)
    assert consts.numel() == sqp_stage.K_LEN
    return consts


def _lib(name, f32):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = HOST + (("-DSRBD_HOST_F32",) if f32 else ())
    return ctypes.CDLL(build.build_host(f"{build.CSRC}/{name}.cu",
                                        flags=flags))


def _inputs(args, cand):
    """(consts, xa, us, xra, dxc, duc, alpha, dx [N+1,12,B] with dx0 in
    row 0) in the arguments' dtype."""
    tp, Q, Qf, R, Ac, bc, xa, us, xra, dxc, duc, alpha, x0s = args
    dtype = xa.dtype
    dx = torch.empty((xa.shape[0], 12, B), dtype=dtype)
    dx[0] = (x0s - (xa[0] + alpha[None] * dxc[0]) if cand
             else x0s - xa[0])
    return _consts(tp, Q, Qf, R, Ac, bc, dtype), xa, us, xra, dxc, duc, \
        alpha, dx


def _split(args, cand, team, rev=False, f32=False):
    """The split kernels' host build (``team``: the emulated team width,
    ``rev``: each team's members in reverse order), run on every lane:
    (dx, du, out5)."""
    fn = _lib("sqp_onepass", f32).srbd_sqp_onepass_split_host
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 20
                   + [ctypes.c_int] * 2 + [ctypes.c_double] * 3)
    fn.restype = ctypes.c_int
    consts, xa, us, xra, dxc, duc, alpha, dx = _inputs(args, cand)
    N, dtype = us.shape[0], xa.dtype
    du, out5 = torch.empty((N, 12, B), dtype=dtype), torch.empty((5, B),
                                                                 dtype=dtype)
    scratch = [torch.empty(s, dtype=dtype) for s in (
        (N, sqp_planes._C, B), (N, sqp_kernel.MERIT_C, B),
        (sqp_planes._T_C, B), *sqp_planes.park_shapes("gains", N, B)[:2])]
    ptrs = [t.data_ptr() for t in (consts, xa, us, xra, dxc, duc, alpha, dx,
                                   dx[1:], du, *out5, *scratch)]
    assert fn(team, int(rev), int(cand), *ptrs, N, B, MU_B, THETA_B,
              REG) == 0
    return dx, du, out5


def _plain(args, cand):
    head, (xa, us, xra, dxc, duc, alpha, x0s) = args[:6], args[6:]
    if cand:
        return sqp_kernel.sqp_qp_solve_onepass_cand_ref(
            *head, xa, us, xra, dxc, duc, alpha, x0s, MU_B, THETA_B, reg=REG)
    return sqp_kernel.sqp_qp_solve_onepass_ref(
        *head, xa, us, xra, x0s - xa[0], MU_B, THETA_B, reg=REG)


@functools.lru_cache(maxsize=None)
def _f64_case(N, cand):
    args = _problem(N, seed=1)
    return args, _plain(args, cand)


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("cand", [True, False])
@pytest.mark.parametrize("N", [5, 20])
def test_split_host_build_matches_plain(N, cand, team):
    """K3s-A, the team Riccati pass and K3s-C compiled as host C++ in double
    precision reproduce the plain version of K3a (cand) or K3b, with the
    team at each emulated width."""
    args, ref = _f64_case(N, cand)
    dx, du, out5 = _split(args, cand, team)
    for got, want in ((dx, ref[0]), (du, ref[1]), (out5[0], ref[2]),
                      *zip(out5[1:], ref[3])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


def _digest(outs) -> str:
    dx, du, out5 = outs
    return hashlib.sha256(b"".join(
        t.contiguous().numpy().tobytes() for t in (dx, du, out5))).hexdigest()


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
@pytest.mark.parametrize("cand", [True, False])
def test_split_f32_host_build_rounds_as_one_thread_body(cand, team, rev):
    """In float32, the three launches give the one-thread body's dx, du,
    dphi, theta, phi, max|defect| and min constraint bit for bit (its
    stored digests), with either member order of a team: the plane pass
    runs that body's stage code, the team forms each entry of the Riccati
    stage with that body's expression, the rollout forms Acl and bcl with
    its expressions and sums each row left to right, and the merit is
    reduced over the stages in its backward order."""
    got = _split(_f32_args(), cand, team, rev, f32=True)
    assert torch.isfinite(got[2]).all()
    assert _digest(got) == ONE_THREAD_F32_DIGEST[cand]


@pytest.mark.parametrize("cand", [True, False])
def test_one_thread_f32_host_build_is_unchanged(cand):
    """The f32 host build at the card's team width gives the outputs that
    the one-thread body gave before its stage linearization, Acl/bcl
    columns and terminal stage became functions shared with the three
    launches."""
    assert _digest(_split(_f32_args(), cand, 16, f32=True)) == \
        ONE_THREAD_F32_DIGEST[cand]


@pytest.mark.parametrize("cand", [True, False])
def test_onepass_designs_raise_on_cpu_tensors(cand):
    """The card-only entries of K3 raise on CPU tensors before anything is
    built."""
    args = _problem(5, seed=0)
    head, (xa, us, xra, dxc, duc, alpha, x0s) = args[:6], args[6:]
    with pytest.raises(TypeError, match="CUDA"):
        if cand:
            sqp_kernel._k3a_cuda(*head, xa, us, xra, dxc, duc, alpha, x0s,
                                 MU_B, THETA_B, reg=REG)
        else:
            sqp_kernel._k3b_cuda(*head, xa, us, xra, x0s - xa[0], MU_B,
                                 THETA_B, reg=REG)
