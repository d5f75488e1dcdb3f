"""PyTorch port of the fused SQP trip (kernel K1) and its three stage
bodies (the gains form, ``rank6=True``, ``factor=True``): the plain version
vs the JAX ``sqp_qp_solve_onepass_planes`` in interpret mode, f64; and the
CUDA source's per-scenario arithmetic, built as host C++ in f64, vs the
plain version.

One JAX call per horizon and body covers both cases: lanes are independent
(no op crosses scenarios), so lanes 0-7 carry the bootstrap case (alpha = 0,
zero dxc/duc) and lanes 8-15 the candidate case (random alpha in
[0.25, 0.75]), each an 8-scenario batch of its own. The rank-6 body is
held to JAX's rank-6 body, not to the gains body: the two differ in
rounding (``tests/test_sqp_planes.py::test_rank6_matches_dense_stage``)."""

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
# the stage bodies besides the default one, by their flag
BODIES = {"rank6": dict(rank6=True), "factor": dict(factor=True)}


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


def _host_kernel(args, body="gains", f32=False, with_parks=False):
    """The kernel's per-scenario body (csrc/sqp_planes.cu) for ``body``,
    built as host C++ (in double precision, or in float32 with ``f32``) and
    run on every lane of K1's arguments ``args``: (dx, du, out5, pack), and
    with ``with_parks`` the body's park arrays after them."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    flags = ("-O2", "-ffp-contract=off") + (("-DSRBD_HOST_F32",) if f32 else ())
    fn = ctypes.CDLL(build.build_host(f"{build.CSRC}/sqp_planes.cu",
                                      flags=flags)).srbd_sqp_planes_host
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 20
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
    pack = torch.empty((N, sqp_planes._C, B), dtype=dtype)
    parks = [torch.empty(s, dtype=dtype) if s else None
             for s in sqp_planes.park_shapes(body, N, B)]
    ins = (consts, xa, us, xra, dxc, duc, alpha)
    assert all(t.dtype == dtype for t in ins)
    ptrs = [t.data_ptr() for t in (*ins, dx, dx[1:], du, *out5, pack)]
    ptrs += [None if t is None else t.data_ptr() for t in parks]
    assert fn(sqp_planes.BODIES.index(body), *ptrs, N, B, *args[13:15],
              REG) == 0
    return (dx, du, out5, pack) + ((parks,) if with_parks else ())


def _host_run(N, body=None):
    """The host f64 build for ``body`` (None: the default one) and the
    plain version on the same inputs."""
    flags = BODIES[body] if body else {}
    params, weights, arr = _problem(N, seed=1)
    args = _port_args(params, weights, arr)
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=REG, **flags)
    return _host_kernel(args, body or "gains")[:3], ref


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


@pytest.mark.parametrize("N", [5, 20])
def test_cuda_source_host_build_matches_plain(N):
    """The kernel's per-scenario body (csrc/sqp_planes.cu) compiled as host
    C++ in double precision reproduces the plain version: it checks the
    hand-written arithmetic of K1 without a card (the CUDA launch itself
    is checked on the card by test_torch_kernels_cuda.py)."""
    _assert_host_matches_plain(*_host_run(N))


@pytest.mark.parametrize("N", [5, 20])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_cuda_source_host_build_body_matches_plain(body, N):
    """As above for the rank-6 and factor instantiations of the kernel's
    per-scenario body, against the plain version with the same flag."""
    _assert_host_matches_plain(*_host_run(N, body))


def _jax_association(Jlt, djl_a, w, Jw):
    """JAX's association of (d Jl^-1 / d r_a) w: the matrix first."""
    from srbd_nmpc_tpu_torch.models import srbd_planes as spl

    return spl.m3v(spl.m3_scale(-1.0, spl.m3(Jlt, spl.m3(djl_a, Jlt))), w)


@pytest.mark.parametrize("association", ["kernel", "jax"])
def test_f32_host_build_rounds_d1_as_plain(monkeypatch, association):
    """Why the plain model forms (d Jl^-1 / d r_a) w as K1 does
    (``srbd_planes.djlt_apply``) and not in JAX's order: K1's plane phase
    built as host C++ in float32 against the plain version's pass 1 in
    float32. The host's sin/cos and PyTorch's do not always round alike,
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
    pack = _host_kernel(args, f32=True)[3].permute(1, 0, 2)   # [87, N, B]
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
# The split gains body (csrc/sqp_planes_split.cu: plane pass, Riccati pass,
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
    lib = ctypes.CDLL(build.build_host(f"{build.CSRC}/sqp_planes_split.cu",
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
    """The three split kernels' arithmetic (csrc/sqp_planes_split.cu)
    compiled as host C++ in double precision reproduces the plain version,
    with the Riccati pass's team at each emulated width."""
    (dx, du, out5), ref = _split_run(N, team)
    lanes = CASES[case]
    _assert_host_matches_plain(
        (dx[..., lanes], du[..., lanes], out5[:, lanes]),
        (ref[0][..., lanes], ref[1][..., lanes], ref[2][lanes],
         tuple(a[lanes] for a in ref[3])))


def _f32_args():
    params, weights, arr = _problem(20, seed=2)
    args = list(_port_args(params, weights, arr))
    for i in range(1, 13):
        args[i] = args[i].to(torch.float32)
    args[0] = dataclasses.replace(args[0], **{
        f.name: getattr(args[0], f.name).to(torch.float32)
        for f in dataclasses.fields(args[0])})
    return args


@pytest.mark.parametrize("team,rev", [
    (w, rev) for w in TEAMS for rev in (False, True)])
def test_split_f32_host_build_rounds_as_one_thread_body(team, rev):
    """In float32, the split kernels give the one-thread gains body's dx,
    du, dphi, max|defect| and min constraint bit for bit, with either
    member order of a team: no sum of the Riccati stage is split between
    threads or reordered, and no step reads what another member writes in
    it. theta and phi are reduced over the stages in the plain version's
    order, where the one-thread body sums stage by stage: they may differ
    in the last bits."""
    args = _f32_args()
    one_dx, one_du, one_out5, _ = _host_kernel(args, f32=True)
    dx, du, out5 = _host_split(args, team, rev, f32=True)
    assert torch.equal(dx, one_dx)
    assert torch.equal(du, one_du)
    for i in (0, 3, 4):                      # dphi, maxdef, mincon
        assert torch.equal(out5[i], one_out5[i])
    for i, name in ((1, "theta"), (2, "phi")):
        rel = float(((out5[i].double() - one_out5[i].double()).abs()
                     / one_out5[i].double().abs()).max())
        print(f"{name}: split vs one-thread body, max relative {rel:.3e}")
        assert rel <= 1e-6


@pytest.mark.parametrize("one_thread", [False, True])
def test_gains_designs_raise_on_what_they_cannot_take(one_thread):
    """The card-only entry of the gains body's kernels, split or one-thread,
    raises on CPU tensors before anything is built."""
    params, weights, arr = _problem(5)
    args = _port_args(params, weights, arr)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._gains_cuda(*args, reg=REG, one_thread=one_thread)


# ---------------------------------------------------------------------------
# The split factor body (the same plane pass, then the factor forms of the
# Riccati pass and of the rollout) built as host C++, as the gains body above
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_factor_host_build_matches_plain(N, case, team):
    """The split factor kernels' arithmetic (the factor forms of the team
    Riccati pass and of the rollout in csrc/sqp_planes_split.cu) compiled
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
    """In float32, the split factor kernels give the one-thread factor
    body's (sqp_planes.cu <kFactor>) dx, du, dphi, max|defect| and min
    constraint bit for bit, and park the same Yh, yv, L (its diagonal
    included) and dinv bit for bit, with either member order of a team.
    theta and phi are reduced in the plain version's order, as the split
    gains body's are (see the gains test above)."""
    args = _f32_args()
    one_dx, one_du, one_out5, _, one_parks = _host_kernel(
        args, "factor", f32=True, with_parks=True)
    dx, du, out5, parks = _host_split(args, team, rev, f32=True,
                                      body="factor")
    assert torch.equal(dx, one_dx)
    assert torch.equal(du, one_du)
    for i in (0, 3, 4):                      # dphi, maxdef, mincon
        assert torch.equal(out5[i], one_out5[i])
    for got, want in zip(parks, one_parks):
        assert torch.equal(got, want)
    for i in (1, 2):                         # theta, phi
        rel = float(((out5[i].double() - one_out5[i].double()).abs()
                     / one_out5[i].double().abs()).max())
        assert rel <= 1e-6


@pytest.mark.parametrize("one_thread", [False, True])
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_factor_designs_raise_on_what_they_cannot_take(one_thread, dtype):
    """The card-only entry of the factor body's kernels, split or
    one-thread, raises on CPU tensors (float64 or float32) before anything
    is built."""
    params, weights, arr = _problem(5)
    args = list(_port_args(params, weights, arr))
    for i in range(6, 13):
        args[i] = args[i].to(dtype)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._factor_cuda(*args, reg=REG, one_thread=one_thread)


# ---------------------------------------------------------------------------
# The split rank-6 body (the same plane pass and rollout, the rank-6 form of
# the team Riccati pass) built as host C++, as the gains body above
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("N", [5, 20])
def test_split_rank6_host_build_matches_plain(N, case, team):
    """The rank-6 form of the team Riccati pass (csrc/sqp_planes_split.cu,
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
    """In float32, the split rank-6 kernels give the one-thread rank-6
    body's (sqp_planes.cu <kRank6>) dx, du, dphi, max|defect| and min
    constraint bit for bit, and park the same K and kv, with either member
    order of a team: no sum of the 6x6 stage is split between members or
    reordered. theta and phi are reduced in the plain version's order, as
    the split gains body's are; they are held bit for bit to the split
    gains body's, whose plane pass and rollout the rank-6 split shares."""
    args = _f32_args()
    one_dx, one_du, one_out5, _, one_parks = _host_kernel(
        args, "rank6", f32=True, with_parks=True)
    dx, du, out5, parks = _host_split(args, team, rev, f32=True,
                                      body="rank6")
    assert torch.equal(dx, one_dx)
    assert torch.equal(du, one_du)
    for i in (0, 3, 4):                      # dphi, maxdef, mincon
        assert torch.equal(out5[i], one_out5[i])
    for got, want in zip(parks, one_parks[:2]):
        assert torch.equal(got, want)
    gains_out5 = _host_split(args, team, rev, f32=True)[2]
    for i in (1, 2):                         # theta, phi
        assert torch.equal(out5[i], gains_out5[i])
        rel = float(((out5[i].double() - one_out5[i].double()).abs()
                     / one_out5[i].double().abs()).max())
        assert rel <= 1e-6


def test_split_rank6_host_build_matches_jax_kernel(jax_refs):
    """The f64 host build of the rank-6 split against JAX's own rank-6 body
    (``rank6=True``, interpret mode) on both cases' lanes at N=20, at the
    tolerances the plain version is held to there."""
    params, weights, arr, ref = jax_refs[("rank6", 20)]
    dx, du, out5, _ = _host_split(_port_args(params, weights, arr), 16,
                                  body="rank6")
    _assert_matches_jax((dx, du, out5[0], tuple(out5[1:])), ref,
                        slice(None))


@pytest.mark.parametrize("one_thread", [False, True])
def test_rank6_designs_raise_on_what_they_cannot_take(one_thread):
    """The card-only entry of the rank-6 body's kernels, split or
    one-thread, raises on CPU tensors before anything is built."""
    params, weights, arr = _problem(5)
    args = _port_args(params, weights, arr)
    with pytest.raises(TypeError, match="CUDA"):
        sqp_planes._rank6_cuda(*args, reg=REG, one_thread=one_thread)
