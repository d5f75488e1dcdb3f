"""PyTorch port of the fused SQP trip (kernel K1) and its three stage
bodies (the gains form, ``rank6=True``, ``factor=True``): the plain version
vs the JAX ``sqp_qp_solve_onepass_planes`` in interpret mode, f64; and the
CUDA source's three launches (``csrc/sqp_planes.cu``), built as host C++,
in f64 vs the plain version and in f32 vs stored digests of their outputs.

One JAX call per horizon and body covers both cases: lanes are independent
(no op crosses scenarios), so lanes 0-7 carry the bootstrap case (alpha = 0,
zero dxc/duc) and lanes 8-15 the candidate case (random alpha in
[0.25, 0.75]), each an 8-scenario batch of its own. The rank-6 body is
held to JAX's rank-6 body, not to the gains body: the two differ in
rounding (``tests/test_sqp_planes.py::test_rank6_matches_dense_stage``)."""

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
from srbd_nmpc_tpu_torch.ops import sqp_planes, sqp_stage
from srbd_nmpc_tpu_torch.utils import build

torch.set_num_threads(1)
F64 = torch.float64
MU_B, THETA_B, REG = 0.1, 5.0, 1e-9
CASES = {"alpha0": slice(0, 8), "alpha": slice(8, 16)}
# the stage bodies besides the default one, by their flag
BODIES = {"rank6": dict(rank6=True), "factor": dict(factor=True)}
# sha256 of the f32 host outputs on _f32_args(N), by (body, N): first of dx,
# du, dphi, max|defect|, min constraint and the body's parks (rank-6: K, kv;
# factor: Yh, yv, L, dinv), as the one-thread bodies that the three launches
# replaced gave them; then of theta and phi, which the launches reduce in the
# plain version's stage order, as they give them at the card's team width
F32_DIGEST = {
    ("gains", 20): (
        "ac51dc9bf3ced0c9364f9d85c624a6cfc87130602ef59834b04d892192433853",
        "62804e8f297c3f1c683023ca3a851eb8e7caf8bda77027b236f2992c01193302"),
    ("rank6", 20): (
        "7cc0357e42a27d3bac49f322b5bf1f761b45f744c291cdfd17c5ef13a10d8185",
        "62804e8f297c3f1c683023ca3a851eb8e7caf8bda77027b236f2992c01193302"),
    ("factor", 20): (
        "cf94a1ae55a3736ed43c749b2ae2d8586f64b57b39b9be9f6a6215538ba26dfc",
        "62804e8f297c3f1c683023ca3a851eb8e7caf8bda77027b236f2992c01193302"),
    ("gains", 5): (
        "c8d4ad5786e5a9c00a4643081238a909b4655a7102a87757f3dd45290c8e2073",
        "0e706bc1f3fb64dd2ffd2264aca0f71c46d37372aea33a8722431db9683e7bef"),
    ("rank6", 5): (
        "d7e9d01a05eb4b94b9ae882c55aa41eda40fed80a54fbdad2d708ec9214d0d44",
        "0e706bc1f3fb64dd2ffd2264aca0f71c46d37372aea33a8722431db9683e7bef"),
    ("factor", 5): (
        "6aa7469ee09f89812fd9c9ea051c12a81db0c4b7c6018b926aa55e6891f87205",
        "0e706bc1f3fb64dd2ffd2264aca0f71c46d37372aea33a8722431db9683e7bef"),
}


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


def _jax_call(params, weights, arr, R=None, **flags):
    from srbd_nmpc_tpu.ops import sqp_planes as jsp

    Ac, bc = jsrbd.constraint_matrix(params)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        res = jsp.sqp_qp_solve_onepass_planes(
            params, weights.Q, weights.Qf, weights.R if R is None else R, Ac,
            bc, *(jnp.asarray(arr[k]) for k in _ORDER), MU_B, THETA_B,
            reg=REG, block=16, **flags)
    finally:
        pl.pallas_call = orig
    return jax_np(res)


@pytest.fixture(scope="module")
def jax_refs():
    """One interpret-mode JAX call per horizon and body, 16 lanes each:
    ``out[N]`` the default body, ``out[(body, N)]`` the others."""
    out = {}
    for N in (5, 20):
        params, weights, arr = _problem(N)
        out[N] = (params, weights, arr, _jax_call(params, weights, arr))
        for body, flags in BODIES.items():
            out[(body, N)] = (params, weights, arr,
                              _jax_call(params, weights, arr, **flags))
    return out


def jax_np(res):
    dx, du, dphi, aux = res
    return (np.asarray(dx), np.asarray(du), np.asarray(dphi),
            tuple(np.asarray(a) for a in aux))


def _assert_matches_jax(got, ref, lanes):
    dx, du, dphi, aux = got
    np.testing.assert_allclose(dx.numpy(), ref[0][..., lanes],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(du.numpy(), ref[1][..., lanes],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dphi.numpy(), ref[2][lanes],
                               rtol=1e-9, atol=1e-9)
    for g, r in zip(aux, ref[3]):
        np.testing.assert_allclose(g.numpy(), r[lanes], rtol=1e-9,
                                   atol=1e-11)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_plain_matches_jax_kernel(jax_refs, N, case):
    params, weights, arr, ref = jax_refs[N]
    lanes = CASES[case]
    before = dict(sqp_planes.launches)
    got = sqp_planes.sqp_qp_solve_onepass_planes(
        *_port_args(params, weights, arr, lanes), reg=REG)
    assert sqp_planes.launches == before   # CPU tensors: the plain version
    _assert_matches_jax(got, ref, lanes)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_body_matches_jax_kernel(jax_refs, body, N, case):
    """The rank-6 and factor bodies against JAX's own (``rank6=True``,
    ``factor=True``) at the default body's tolerances."""
    params, weights, arr, ref = jax_refs[(body, N)]
    lanes = CASES[case]
    before = dict(sqp_planes.launches)
    got = sqp_planes.sqp_qp_solve_onepass_planes(
        *_port_args(params, weights, arr, lanes), reg=REG, **BODIES[body])
    assert sqp_planes.launches == before   # CPU tensors: the plain version
    _assert_matches_jax(got, ref, lanes)


def test_rank6_on_dense_R_runs_the_12x12_stage():
    """rank6=True with R coupling the legs falls back to the 12x12 stage,
    silently, as in JAX: the result matches JAX's rank6=True call and is
    bitwise the default body's."""
    params, weights, arr = _problem(5, seed=9)
    R = np.asarray(weights.R) + 1e-6 * np.ones((12, 12))
    ref = _jax_call(params, weights, arr, R=jnp.asarray(R), rank6=True)
    args = list(_port_args(params, weights, arr))
    args[3] = torch.as_tensor(R)
    assert not sqp_stage.r_leg_diagonal(args[3])
    assert sqp_stage.r_leg_diagonal(_port_args(params, weights, arr)[3])
    got = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=REG, rank6=True)
    _assert_matches_jax(got, ref, slice(None))
    gains = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=REG)
    for g, r in zip((*got[:3], *got[3]), (*gains[:3], *gains[3])):
        assert torch.equal(g, r)


def test_factor_with_rank6_raises():
    params, weights, arr = _problem(5)
    for fn in (sqp_planes.sqp_qp_solve_onepass_planes,
               sqp_planes.sqp_qp_solve_onepass_planes_ref):
        with pytest.raises(ValueError, match="rank-6"):
            fn(*_port_args(params, weights, arr), reg=REG, factor=True,
               rank6=True)


def test_non_leg_block_diagonal_constraints_raise():
    params, weights, arr = _problem(5)
    args = list(_port_args(params, weights, arr))
    Ac = args[4].clone()
    Ac[0, 7] = 0.5
    args[4] = Ac
    with pytest.raises(ValueError, match="leg-block-diagonal"):
        sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=REG)


def _host_consts(tp, Q, Qf, R, Ac, bc, dtype):
    """K1's constants block (``sqp_stage.kernel_constants``' layout)."""
    Ac1, Ac2 = Ac[0:12, 0:6], Ac[12:24, 6:12]
    consts = torch.cat([tp.mass.reshape(1), tp.dt.reshape(1),
                        tp.inertia_inv.reshape(9), tp.foot_pos.reshape(6),
                        Ac1.reshape(72), Ac2.reshape(72), bc.reshape(24),
                        R.reshape(144), Q.reshape(144),
                        Qf.reshape(144)]).to(dtype)
    assert consts.numel() == sqp_stage.K_LEN
    return consts


def _assert_host_matches_plain(got, ref):
    dx, du, out5 = got
    np.testing.assert_allclose(dx.numpy(), ref[0].numpy(), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(du.numpy(), ref[1].numpy(), rtol=1e-12,
                               atol=1e-11)
    np.testing.assert_allclose(out5[0].numpy(), ref[2].numpy(), rtol=1e-12)
    for i in range(4):
        np.testing.assert_allclose(out5[1 + i].numpy(), ref[3][i].numpy(),
                                   rtol=1e-12, atol=1e-13)


def _jax_association(Jlt, djl_a, w, Jw):
    """JAX's association of (d Jl^-1 / d r_a) w: the matrix first."""
    from srbd_nmpc_tpu_torch.models import srbd_planes as spl

    return spl.m3v(spl.m3_scale(-1.0, spl.m3(Jlt, spl.m3(djl_a, Jlt))), w)


@pytest.mark.parametrize("association", ["kernel", "jax"])
def test_f32_host_build_rounds_d1_as_plain(monkeypatch, association):
    """Why the plain model forms (d Jl^-1 / d r_a) w as K1 does
    (``srbd_planes.djlt_apply``) and not in JAX's order: K1's plane pass
    (K1s-A's float32 form, ``plane_stage``) built as host C++ in float32
    against the plain version's pass 1 in float32. The host's sin/cos and PyTorch's do not always round alike,
    so the comparison is made on the (stage, lane) pairs whose D2 (the
    same chain without the derivative term) is bitwise the plain one's.
    There D1 is bitwise the plain one's with K1's association, and almost
    never with JAX's."""
    from srbd_nmpc_tpu_torch.models import srbd_planes as spl

    params, weights, arr = _problem(20, seed=2)
    args = list(_port_args(params, weights, arr))
    for i in range(6, 13):
        args[i] = args[i].to(torch.float32)
    tp, Q, Qf, R, Ac, bc, xa, us, xra, dxc, duc, alpha = args[:12]
    args[0] = dataclasses.replace(tp, **{
        f.name: getattr(tp, f.name).to(torch.float32)
        for f in dataclasses.fields(tp)})
    pack = _host_planes(args, False, False, f32=True)[0].permute(1, 0, 2)
    if association == "jax":
        monkeypatch.setattr(spl, "djlt_apply", _jax_association)
    Ac1, Ac2 = sqp_stage._split_leg_blocks(Ac.to(torch.float32))
    _, ref, _, _ = sqp_planes._planes_phase(
        args[0], Q.float(), Qf.float(), R.float(), Ac1, Ac2, bc.float(),
        xa, us, xra, dxc, duc, alpha, MU_B, THETA_B)
    d2_same = (pack[9:18] == ref[9:18]).all(0)
    d1_same = (pack[0:9] == ref[0:9]).all(0)
    assert int(d2_same.sum()) >= d2_same.numel() // 2
    share = float((d1_same & d2_same).sum() / d2_same.sum())
    if association == "kernel":
        assert share >= 0.99
    else:
        assert share <= 0.05


# ---------------------------------------------------------------------------
# The split gains body (csrc/sqp_planes.cu: plane pass, Riccati pass,
# rollout) built as host C++, each team of the Riccati pass emulated with its
# members one after another within each step
# ---------------------------------------------------------------------------

# team widths of the Riccati pass to emulate: the card's (16) and two more,
# since the rounding must not depend on how a stage's work items fall to the
# members
TEAMS = (8, 16, 32)


def _host_split(args, team, rev=False, f32=False, body="gains"):
    """The split kernels' host build (``team``: the emulated team width,
    ``rev``: each team's members in reverse order) for ``body`` (the gains
    body; ``"rank6"``: the rank-6 form of the Riccati pass; ``"factor"``:
    the factor forms of the Riccati pass and of the rollout) run on every
    lane of K1's arguments ``args``: (dx, du, out5), and for the rank-6 and
    factor bodies their parks after them ([K, kv], [Yh, yv, L, dinv])."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = ("-O2", "-ffp-contract=off") + (("-DSRBD_HOST_F32",) if f32 else ())
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/sqp_planes.cu",
                                       flags=flags))
    factor = body == "factor"
    fn = {"gains": lib.srbd_sqp_planes_split_host,
          "rank6": lib.srbd_sqp_planes_split_rank6_host,
          "factor": lib.srbd_sqp_planes_split_factor_host}[body]
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * (20 + 2 * factor)
                   + [ctypes.c_int] * 2 + [ctypes.c_double] * 3)
    fn.restype = ctypes.c_int
    tp, Q, Qf, R, Ac, bc, xa, us, xra, dxc, duc, alpha, x0s = args[:13]
    N, B = us.shape[0], xa.shape[-1]
    dtype = torch.float32 if f32 else F64
    consts = _host_consts(tp, Q, Qf, R, Ac, bc, dtype)
    dx = torch.empty((N + 1, 12, B), dtype=dtype)
    dx[0] = x0s - (xa[0] + alpha[None] * dxc[0])
    du = torch.empty((N, 12, B), dtype=dtype)
    out5 = torch.empty((5, B), dtype=dtype)
    scratch = [torch.empty(s, dtype=dtype) for s in (
        (N, sqp_planes._C, B), (N, sqp_planes._M_C, B), (sqp_planes._T_C, B))]
    parks = [torch.empty(s, dtype=dtype)
             for s in sqp_planes.park_shapes(body, N, B) if s]
    ins = (consts, xa, us, xra, dxc, duc, alpha)
    assert all(t.dtype == dtype for t in ins)
    ptrs = [t.data_ptr() for t in (*ins, dx, dx[1:], du, *out5, *scratch,
                                   *parks)]
    assert fn(team, int(rev), *ptrs, N, B, *args[13:15], REG) == 0
    return (dx, du, out5) + ((parks,) if body != "gains" else ())


@functools.lru_cache(maxsize=None)
def _split_run(N, team, body="gains"):
    """The split host f64 build for ``body`` and the plain version with the
    same body on the same inputs (every lane: 0-7 alpha = 0, 8-15 random
    alpha)."""
    params, weights, arr = _problem(N, seed=1)
    args = _port_args(params, weights, arr)
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(
        *args, reg=REG, **BODIES.get(body, {}))
    return _host_split(args, team, body=body)[:3], ref


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_host_build_matches_plain(N, case, team):
    """The three split kernels' arithmetic (csrc/sqp_planes.cu)
    compiled as host C++ in double precision reproduces the plain version,
    with the Riccati pass's team at each emulated width."""
    (dx, du, out5), ref = _split_run(N, team)
    lanes = CASES[case]
    _assert_host_matches_plain(
        (dx[..., lanes], du[..., lanes], out5[:, lanes]),
        (ref[0][..., lanes], ref[1][..., lanes], ref[2][lanes],
         tuple(a[lanes] for a in ref[3])))


@functools.lru_cache(maxsize=None)
def _plain_run(N, body):
    """K1's arguments (every lane: 0-7 alpha = 0, 8-15 random alpha) and the
    plain version of ``body`` on them, in double."""
    params, weights, arr = _problem(N, seed=1)
    args = _port_args(params, weights, arr)
    return args, sqp_planes.sqp_qp_solve_onepass_planes_ref(
        *args, reg=REG, **BODIES.get(body, {}))


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
@pytest.mark.parametrize("body", ["gains", "factor"])
def test_split_team_steps_match_plain_in_either_order(body, team, rev):
    """The gains and factor forms' team steps (k1s_passes.cuh::riccati_team:
    the stage's groups, Ac's columns and L's rows read 16 bytes at a time,
    the Cholesky and the forward substitution in shared steps with L's rows
    and Y's columns in the members' registers, X0 in P's place, G's and P's
    entries in rounds of their own) compiled as host C++ in double
    reproduce the plain version on every lane, with the team at each
    emulated width in either member order: no step reads what another
    member writes in it, and no member's registers are read by another."""
    args, ref = _plain_run(20, body)
    dx, du, out5 = _host_split(args, team, rev=rev, body=body)[:3]
    _assert_host_matches_plain((dx, du, out5), ref)


def _f32_args(N=20):
    params, weights, arr = _problem(N, seed=2)
    args = list(_port_args(params, weights, arr))
    for i in range(1, 13):
        args[i] = args[i].to(torch.float32)
    args[0] = dataclasses.replace(args[0], **{
        f.name: getattr(args[0], f.name).to(torch.float32)
        for f in dataclasses.fields(args[0])})
    return args


def _digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _assert_f32_digests(body, N, team, rev):
    """The f32 host build of ``body``'s three launches against
    ``F32_DIGEST[(body, N)]``."""
    got = _host_split(_f32_args(N), team, rev, f32=True, body=body)
    dx, du, out5 = got[:3]
    parks = got[3] if body != "gains" else []
    exact, reduced = F32_DIGEST[(body, N)]
    assert torch.isfinite(out5).all()
    assert _digest([dx, du, out5[0], out5[3], out5[4], *parks]) == exact
    assert _digest([out5[1], out5[2]]) == reduced


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
def test_split_f32_host_build_rounds_as_one_thread_body(team, rev):
    """In float32, the three launches give the one-thread gains body's dx,
    du, dphi, max|defect| and min constraint bit for bit (stored digests of
    that body's outputs), with either member order of a team: no sum of the
    Riccati stage is split between threads or reordered, and no step reads
    what another member writes in it. theta and phi are reduced over the
    stages in the plain version's order, where the one-thread body summed
    stage by stage: their digest is the launches' own, the same at every
    team width and member order."""
    _assert_f32_digests("gains", 20, team, rev)


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("body", ["gains", "rank6", "factor"])
def test_split_f32_host_build_matches_digest_at_n5(body, rev):
    """The f32 digests at N=5, for each body, at the card's team width (16)
    in either member order."""
    _assert_f32_digests(body, 5, 16, rev)


@pytest.mark.parametrize("rev", [False, True])
def test_split_f64_card_form_matches_plain(rev):
    """The float64 form of the three launches at the card's layout: the
    split source's f64 host build, whose team array in double is the
    card's (752 doubles; the source's static assertions hold 4 such teams
    and K1s-B's constants in double within 48 KB of static shared memory
    and 8 blocks within an SM's 228 KB, or it does not build), and whose
    plane pass runs as the card's float64 form does (a stage of a lane
    spread over the threads of its parts, ``plane_part``), with
    the card's team width (16) in either member order and the plane pass's
    parts in either order reproduces the plain version in double on every
    lane."""
    params, weights, arr = _problem(20, seed=1)
    args = _port_args(params, weights, arr)
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=REG)
    dx, du, out5 = _host_split(args, 16, rev=rev)
    _assert_host_matches_plain((dx, du, out5), ref)


def _host_planes(args, split, rev, f32=False):
    """K1s-A alone from the source's host build (``srbd_k1s_planes_host``;
    f64, or f32 with ``f32``) on every stage and lane of K1's arguments
    ``args``: (pack, mer, term), by ``plane_stage``, a thread a (stage,
    lane), or (``split``, f64 only) by the float64 form's parts, in part
    order or (``rev``) in reverse. Every output starts NaN, so that an entry
    no part writes shows."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = ("-O2", "-ffp-contract=off") + (("-DSRBD_HOST_F32",) if f32 else ())
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/sqp_planes.cu",
                                       flags=flags))
    fn = lib.srbd_k1s_planes_host
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 2 + [ctypes.c_double] * 2)
    fn.restype = ctypes.c_int
    tp, Q, Qf, R, Ac, bc, xa, us, xra, dxc, duc, alpha = args[:12]
    N, B = us.shape[0], xa.shape[-1]
    dtype = torch.float32 if f32 else F64
    consts = _host_consts(tp, Q, Qf, R, Ac, bc, dtype)
    assert all(t.dtype == dtype for t in (xa, us, xra, dxc, duc, alpha))
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in (
        (N, sqp_planes._C, B), (N, sqp_planes._M_C, B), (sqp_planes._T_C, B))]
    ptrs = [t.data_ptr() for t in (consts, xa, us, xra, dxc, duc, alpha, *outs)]
    assert fn(int(split), int(rev), *ptrs, N, B, *args[13:15]) == 0
    return outs


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_f64_plane_pass_writes_the_one_thread_stage(N, case, rev):
    """The float64 plane pass spread over a thread for each of its parts a
    (stage, lane), the parts run in either order, writes the pack, merit
    terms and terminal stage of ``plane_stage<double>`` (one thread a
    (stage, lane)) bit for bit, on every channel: each entry keeps its expression and sum order,
    and no sum is split between the threads."""
    params, weights, arr = _problem(N, seed=3)
    args = _port_args(params, weights, arr)
    one = _host_planes(args, False, False)
    split = _host_planes(args, True, rev)
    lanes = CASES[case]
    for name, o, g in zip(("pack", "mer", "term"), one, split):
        o, g = o[..., lanes], g[..., lanes]
        assert torch.isfinite(o).all(), name
        assert torch.equal(g.view(torch.int64), o.view(torch.int64)), name


@pytest.mark.parametrize("kw,dtype", [
    (dict(), "float64"), (dict(rank6=True), "float32"),
    (dict(factor=True), "float32")])
def test_float64_takes_the_gains_split_kernels_only(kw, dtype):
    """A float64 batch is checked against the float64 form of the gains
    body's kernels; the rank-6 and factor bodies take float32 only (on CPU
    tensors each raises before anything is built, naming the dtype it
    takes)."""
    params, weights, arr = _problem(5)
    args = _port_args(params, weights, arr)
    with pytest.raises(TypeError, match=f"takes {dtype} CUDA tensors"):
        sqp_planes._solve_cuda(*args, reg=REG, rank6=kw.get("rank6", False),
                               factor=kw.get("factor", False), consts=None)


def test_gains_designs_raise_on_what_they_cannot_take():
    """The card-only entry of the gains body's kernels raises on CPU
    tensors before anything is built."""
    params, weights, arr = _problem(5)
    args = _port_args(params, weights, arr)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._gains_cuda(*args, reg=REG)


# ---------------------------------------------------------------------------
# The split factor body (the same plane pass, then the factor forms of the
# Riccati pass and of the rollout) built as host C++, as the gains body above
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_factor_host_build_matches_plain(N, case, team):
    """The split factor kernels' arithmetic (the factor forms of the team
    Riccati pass and of the rollout in csrc/sqp_planes.cu) compiled
    as host C++ in double precision reproduces the plain factor body to
    1e-12 (relative and absolute), with the team at each emulated width."""
    (dx, du, out5), ref = _split_run(N, team, "factor")
    lanes = CASES[case]
    for got, want in ((dx, ref[0]), (du, ref[1]), (out5[0], ref[2]),
                      *zip(out5[1:], ref[3])):
        np.testing.assert_allclose(got[..., lanes].numpy(),
                                   want[..., lanes].numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
def test_split_factor_f32_host_build_rounds_as_one_thread_body(team, rev):
    """In float32, the factor forms give the one-thread factor body's dx,
    du, dphi, max|defect| and min constraint bit for bit, and park the same
    Yh, yv, L (its diagonal included) and dinv bit for bit (stored digests
    of that body's outputs), with either member order of a team. theta and
    phi are reduced in the plain version's order, as the gains body's are
    (see the gains test above): the same digest as the gains body's."""
    _assert_f32_digests("factor", 20, team, rev)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_factor_designs_raise_on_what_they_cannot_take(dtype):
    """The card-only entry of the factor body's kernels raises on CPU
    tensors (float64 or float32) before anything is built."""
    params, weights, arr = _problem(5)
    args = list(_port_args(params, weights, arr))
    for i in range(6, 13):
        args[i] = args[i].to(dtype)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._factor_cuda(*args, reg=REG)


# ---------------------------------------------------------------------------
# The split rank-6 body (the same plane pass and rollout, the rank-6 form of
# the team Riccati pass) built as host C++, as the gains body above
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_rank6_host_build_matches_plain(N, case, team):
    """The rank-6 form of the team Riccati pass (csrc/sqp_planes.cu,
    between the plane pass and the gains rollout) compiled as host C++ in
    double precision reproduces the plain rank-6 body to 1e-12 (relative
    and absolute), with the team at each emulated width."""
    (dx, du, out5), ref = _split_run(N, team, "rank6")
    lanes = CASES[case]
    for got, want in ((dx, ref[0]), (du, ref[1]), (out5[0], ref[2]),
                      *zip(out5[1:], ref[3])):
        np.testing.assert_allclose(got[..., lanes].numpy(),
                                   want[..., lanes].numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
def test_split_rank6_f32_host_build_rounds_as_one_thread_body(team, rev):
    """In float32, the rank-6 form gives the one-thread rank-6 body's dx,
    du, dphi, max|defect| and min constraint bit for bit, and parks the same
    K and kv (stored digests of that body's outputs), with either member
    order of a team: no sum of the 6x6 stage is split between members or
    reordered. theta and phi are reduced in the plain version's order, as
    the gains body's are; they are held bit for bit to the gains body's,
    whose plane pass and rollout the rank-6 form shares."""
    _assert_f32_digests("rank6", 20, team, rev)
    args = _f32_args()
    out5 = _host_split(args, team, rev, f32=True, body="rank6")[2]
    gains_out5 = _host_split(args, team, rev, f32=True)[2]
    for i in (1, 2):                         # theta, phi
        assert torch.equal(out5[i], gains_out5[i])


def test_split_rank6_host_build_matches_jax_kernel(jax_refs):
    """The f64 host build of the rank-6 split against JAX's own rank-6 body
    (``rank6=True``, interpret mode) on both cases' lanes at N=20, at the
    tolerances the plain version is held to there."""
    params, weights, arr, ref = jax_refs[("rank6", 20)]
    dx, du, out5, _ = _host_split(_port_args(params, weights, arr), 16,
                                  body="rank6")
    _assert_matches_jax((dx, du, out5[0], tuple(out5[1:])), ref,
                        slice(None))


def test_rank6_designs_raise_on_what_they_cannot_take():
    """The card-only entry of the rank-6 body's kernels raises on CPU
    tensors before anything is built."""
    params, weights, arr = _problem(5)
    args = _port_args(params, weights, arr)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._rank6_cuda(*args, reg=REG)
