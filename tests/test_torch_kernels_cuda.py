"""The port's CUDA kernels against their plain PyTorch versions on the card
(K1 fused SQP trip with its three stage bodies, each also by its one-thread
kernel, K2 lane permutes, K3a/K3b dense one-pass trips (split and
one-thread), K4 the two-pass solve (K4a split and one-thread), K5 stage
linearization, K6 Riccati backward and forward passes (the backward pass
by its team kernel and its one-thread yardstick),
K7a line-search merit, K7b merit with and without gradients), at
the main path's widths; one synchronous ``pallas`` solve that launches K5,
K6 and K7a, the dense route's solves on both loops, the ``park_factor``
solve through K1's factor body, the batched merit ``engine._merit_fast``
through K7b (and past it for a float64 batch), and the single-scenario
solve on the card against the CPU.

Needs a CUDA card and nvcc: on a machine without a card every test skips.
Run on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srbd_nmpc_tpu_torch.models import merit_kernel, srbd, srbd_linearize
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
from srbd_nmpc_tpu_torch.ops import (permute, riccati_kernel, sqp_kernel,
                                     sqp_planes)
from srbd_nmpc_tpu_torch.parallel import sharded
from srbd_nmpc_tpu_torch.utils.config import MpcOptions
from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

pytestmark = pytest.mark.gpu


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _k1_args(dev, N, B, alpha_zero, seed=0):
    rng = np.random.default_rng(seed)
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)

    def T(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    xa = T(rng.normal(size=(N + 1, 12, B)) * 0.3)
    us = T(rng.normal(size=(N, 12, B)) * 30 + 80)
    xra = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    x0s = T(x0.cpu().numpy()[:, None] + 0.01 * rng.normal(size=(12, B)))
    if alpha_zero:
        dxc, duc = torch.zeros_like(xa), torch.zeros_like(us)
        alpha = torch.zeros(B, dtype=torch.float32, device=dev)
    else:
        dxc = T(rng.normal(size=(N + 1, 12, B)) * 0.05)
        duc = T(rng.normal(size=(N, 12, B)) * 2.0)
        alpha = T(0.25 + 0.5 * rng.random(B))
    Ac, bc = srbd.constraint_matrix(params)
    return (params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us, xra,
            dxc, duc, alpha, x0s, cfg.mu_barrier, cfg.theta_barrier)


K1_BODIES = {"gains": {}, "rank6": dict(rank6=True),
             "factor": dict(factor=True)}


@pytest.mark.parametrize("alpha_zero", [True, False])
@pytest.mark.parametrize("body", sorted(K1_BODIES))
def test_k1_matches_plain(dev, body, alpha_zero):
    """Each stage body against its plain version; the benchmark weights
    are leg-block-diagonal, so rank6=True runs the rank-6 body. The gains
    body also through ``sqp_planes._gains_cuda``: the split kernels and the
    one-thread kernel, each call counted once."""
    args = _k1_args(dev, 20, 4096, alpha_zero)
    flags = K1_BODIES[body]
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=1e-9,
                                                     **flags)
    calls = [lambda: sqp_planes.sqp_qp_solve_onepass_planes(
        *args, reg=1e-9, **flags)]
    if body == "gains":
        calls += [lambda o=o: sqp_planes._gains_cuda(*args, reg=1e-9,
                                                     one_thread=o)
                  for o in (False, True)]
    for call in calls:
        before = dict(sqp_planes.launches)
        got = call()
        torch.cuda.synchronize()
        assert sqp_planes.launches == {**before, body: before[body] + 1}
        for g, r in zip(got[:3], ref[:3]):
            assert torch.isfinite(g).all()
            assert parity_metric(g.cpu().numpy(), r.cpu().numpy()) < 1e-4
        for g, r in zip(got[3][:2], ref[3][:2]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=1e-4)


def test_k1_rank6_on_dense_R_runs_the_12x12_body(dev):
    """R coupling the legs: rank6=True runs the gains body, as in JAX,
    decided from the constants block without a read-back of R."""
    args = list(_k1_args(dev, 20, 1024, False))
    args[3] = args[3] + 1e-6
    before = dict(sqp_planes.launches)
    got = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9, rank6=True)
    torch.cuda.synchronize()
    assert sqp_planes.launches == {**before, "gains": before["gains"] + 1}
    ref = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9)
    for g, r in zip((*got[:3], *got[3]), (*ref[:3], *ref[3])):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="rank-6"):
        sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9, rank6=True,
                                               factor=True)


@pytest.mark.parametrize("alpha_zero", [True, False])
@pytest.mark.parametrize("B", [4096, 4093])
def test_k1_factor_split_and_one_thread_match_plain(dev, B, alpha_zero):
    """The factor body through its split kernels (the public entry's) and
    through the one-thread yardstick ``sqp_planes.cu <kFactor>`` against
    the plain factor body, at B=4096 and at a width that is not a multiple
    of a block's 8 teams (a ragged edge): the split kernels equal to plain
    bit for bit on all seven outputs; the one-thread kernel on dx, du,
    dphi, max|defect| and min constraint (it sums theta and phi stage by
    stage, the plain version per component over the stages)."""
    args = _k1_args(dev, 20, B, alpha_zero)
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=1e-9,
                                                     factor=True)
    before = sqp_planes.launches["factor"]
    split = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9,
                                                   factor=True)
    one = sqp_planes._factor_cuda(*args, reg=1e-9, one_thread=True)
    torch.cuda.synchronize()
    assert sqp_planes.launches["factor"] == before + 2
    ref = (*ref[:3], *ref[3])
    for g, r in zip((*split[:3], *split[3]), ref):
        assert torch.isfinite(g).all()
        assert torch.equal(g, r)
    for i, (g, r) in enumerate(zip((*one[:3], *one[3]), ref)):
        if i in (3, 4):                      # theta, phi
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=1e-4)
        else:
            assert torch.equal(g, r)


@pytest.mark.parametrize("alpha_zero", [True, False])
@pytest.mark.parametrize("B", [4096, 4093])
def test_k1_rank6_split_and_one_thread_match_plain(dev, B, alpha_zero):
    """The rank-6 body through its split kernels (the public entry's) and
    through the one-thread yardstick ``sqp_planes.cu <kRank6>``
    against the plain rank-6 body, at B=4096 and at a ragged width: the
    split kernels equal to plain bit for bit on all seven outputs; the
    one-thread kernel on all but theta and phi (summed stage by stage)."""
    args = _k1_args(dev, 20, B, alpha_zero)
    ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=1e-9,
                                                     rank6=True)
    before = sqp_planes.launches["rank6"]
    split = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9,
                                                   rank6=True)
    one = sqp_planes._rank6_cuda(*args, reg=1e-9, one_thread=True)
    torch.cuda.synchronize()
    assert sqp_planes.launches["rank6"] == before + 2
    ref = (*ref[:3], *ref[3])
    for g, r in zip((*split[:3], *split[3]), ref):
        assert torch.isfinite(g).all()
        assert torch.equal(g, r)
    for i, (g, r) in enumerate(zip((*one[:3], *one[3]), ref)):
        if i in (3, 4):                      # theta, phi
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=1e-4)
        else:
            assert torch.equal(g, r)


def test_k1_rejects_float64(dev):
    args = list(_k1_args(dev, 20, 64, True))
    for i in range(6, 13):
        args[i] = args[i].double()
    with pytest.raises(TypeError, match="float32"):
        sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=1e-9)


# K2 cases (leading shape, B, Bc, index pattern), as chip_smoke.py phase 3
K2_CASES = [((21, 12), 131072, 65536, "uniform"),
            ((21, 12), 131072, 65536, "clumpy"),
            ((21, 12), 131072, 4096, "uniform"),
            ((21, 12), 131072, 4096, "clumpy"),
            ((21, 12), 131072, 65536, "dense"),
            ((21, 12), 131072, 131072, "dense"),
            ((12,), 131072, 65536, "uniform"),
            ((7,), 500, 77, "uniform"),
            ((3, 12), 4099, 1031, "clumpy"),
            ((1,), 1000, 250, "uniform")]


def _k2_inputs(dev, lead, B, Bc, pattern, seed=0):
    """Data with -0, infinities and NaN payloads among it, a source for
    the scatter and a sorted unique (int64) index list."""
    rng = np.random.default_rng(seed)

    def words(shape):
        a = rng.normal(size=shape).astype(np.float32)
        flat = a.reshape(-1).view(np.uint32)
        flat[rng.choice(flat.size, 6, replace=False)] = np.array(
            [0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFBADBAD,
             0x7F812345], np.uint32)
        return torch.as_tensor(a, device=dev)

    if pattern == "dense":
        idx = np.arange(Bc)
    else:
        p = np.ones(B)
        if pattern == "clumpy":
            p[: B // 3] = 8.0
            p[-B // 5:] = 0.05
        idx = np.sort(rng.choice(B, Bc, replace=False, p=p / p.sum()))
    return words(lead + (B,)), words(lead + (Bc,)), torch.as_tensor(idx,
                                                                   device=dev)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("lead,B,Bc,pattern", K2_CASES)
def test_k2_bitwise(dev, lead, B, Bc, pattern, idx_dtype):
    a, src, idx64 = _k2_inputs(dev, lead, B, Bc, pattern, seed=Bc)
    idx = idx64.to(idx_dtype)
    before = dict(permute.launches)
    got = permute.take_lanes(a, idx)
    got_s = permute.set_lanes(a, src, idx)
    torch.cuda.synchronize()
    assert permute.launches["take_lanes"] == before["take_lanes"] + 1
    assert permute.launches["set_lanes"] == before["set_lanes"] + 1
    assert torch.equal(_bits(got), _bits(permute.take_lanes_ref(a, idx64)))
    assert torch.equal(_bits(got_s),
                       _bits(permute.set_lanes_ref(a, src, idx64)))


def _k2_calls(dev):
    """One take_lanes and one set_lanes call with the engine's int64 idx."""
    a, src, idx = _k2_inputs(dev, (21, 12), 131072, 65536, "uniform")
    return [lambda: permute.take_lanes(a, idx),
            lambda: permute.set_lanes(a, src, idx)]


def _k3_calls(dev):
    """One call of K3a and one of K3b through their public entries."""
    args = _k1_args(dev, 20, 1024, False)
    head, (xa, us, xra, dxc, duc, alpha, x0s), tail = \
        args[:6], args[6:13], args[13:]
    return [lambda: sqp_kernel.sqp_qp_solve_onepass_cand(
                *head, xa, us, xra, dxc, duc, alpha, x0s, *tail, reg=1e-9),
            lambda: sqp_kernel.sqp_qp_solve_onepass(
                *head, xa, us, xra, x0s - xa[0], *tail, reg=1e-9)]


def _k1_calls(dev):
    """One call of each K1 stage body (gains, rank-6, factor)."""
    args = _k1_args(dev, 20, 1024, False)
    return [lambda f=f: sqp_planes.sqp_qp_solve_onepass_planes(
        *args, reg=1e-9, **f) for f in K1_BODIES.values()]


def _k4a_calls(dev):
    """One call of K4a through its public entry."""
    args = _k1_args(dev, 20, 1024, False)
    head, tail = args[:9], args[13:]
    return [lambda: sqp_kernel.sqp_qp_backward(*head, *tail, reg=1e-9)]


def _k5_k7a_calls(dev):
    """One call of K5 (``srbd_linearize.linearize``) and one of K7a
    (``merit_kernel.merit_alpha``) through their public entries."""
    lin, _, merit = _sync_args(dev, 1024)
    # the constants blocks built beforehand, as the engine builds them once
    # per solve: the calls then launch nothing else
    k5c = srbd_linearize.kernel_constants(*lin[:5]).to(dev)
    k7c = merit_kernel.kernel_constants(*merit[:6]).to(dev)
    return [lambda: srbd_linearize.linearize(*lin, consts=k5c),
            lambda: merit_kernel.merit_alpha(*merit, consts=k7c)]


def _k6_calls(dev):
    """One lqr_backward call with stage-constant (Q, Qf) (K6a) and one with
    a per-stage Q (K6b)."""
    args = {c: _k6_args(dev, 1024, c) for c in (True, False)}
    return [lambda c=c: riccati_kernel.lqr_backward(*args[c])
            for c in (True, False)]


_PROFILE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {tests!r})
import test_torch_kernels_cuda as t
calls = t.{calls}(torch.device("cuda"))
for call in calls:
    call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for call in calls:
        call()
    torch.cuda.synchronize()
print(json.dumps({{e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}}))
"""


def _device_kernels(calls: str) -> dict:
    """Device kernels (name: launches) of the calls that ``calls`` (the
    name of a function of this module) builds, each run once after a
    warm-up, under one torch.profiler session in a fresh process: no
    state of another session in this process can reach the count."""
    tests = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _PROFILE.format(tests=tests, calls=calls)],
        cwd=os.path.dirname(tests), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_k2_one_device_kernel_per_call(dev):
    """With the engine's int64 idx, one take_lanes or set_lanes call runs
    one device kernel: no cast, no copy launch."""
    kernels = _device_kernels("_k2_calls")
    assert sum(kernels.values()) == 2
    for name in ("take_lanes_kernel", "set_lanes_kernel"):
        assert sum(n for k, n in kernels.items() if name in k) == 1


def test_k1_one_kernel_per_call(dev):
    """One call of each stage body: the gains body launches the three split
    kernels (the plane pass, the Riccati pass, the rollout) once each, the
    rank-6 body the same plane pass and rollout and the rank-6 form of the
    Riccati pass, the factor body
    the same plane pass and the factor forms of the other two once each; no
    one-thread body (sqp_planes_kernel) runs."""
    kernels = _device_kernels("_k1_calls")
    assert not any("sqp_planes_kernel" in k for k in kernels)
    split = {k: n for k, n in kernels.items() if "k1s_" in k}
    assert sum(split.values()) == 9
    for name, n in (("k1s_planes_kernel", 3), ("k1s_riccati_team_kernel", 1),
                    ("k1s_riccati_rank6_kernel", 1), ("k1s_rollout_kernel", 2),
                    ("k1s_riccati_factor_kernel", 1),
                    ("k1s_rollout_factor_kernel", 1)):
        assert sum(v for k, v in split.items() if name in k) == n, kernels


def test_k4a_four_kernels_per_call(dev):
    """One sqp_qp_backward call launches K4a's four split kernels once each
    (K5's k5s_stage_kernel and k5s_dense_kernel, k4s_merit_kernel,
    riccati_team_acl_kernel) and no other kernel of the port's: not the
    one-thread sqp_twopass_bwd_kernel, nor K5's, K6's one-launch bodies
    (the rest are PyTorch's own, which build the constants block)."""
    kernels = _device_kernels("_k4a_calls")
    for name in ("sqp_twopass_bwd_kernel", "linearize_kernel",
                 "riccati_team_kernel", "riccati_bwd_kernel"):
        assert not any(name in k for k in kernels), kernels
    for name in ("k5s_stage_kernel", "k5s_dense_kernel", "k4s_merit_kernel",
                 "riccati_team_acl_kernel"):
        assert sum(v for k, v in kernels.items() if name in k) == 1, kernels


def test_k3_three_kernels_per_call(dev):
    """One K3a and one K3b call each launch the three split kernels once:
    the plane pass (its <true> and <false> instantiations), the team
    Riccati pass k1s_riccati_team_kernel and the rollout; the one-thread
    body does not run."""
    kernels = _device_kernels("_k3_calls")
    assert not any("sqp_onepass_kernel" in k for k in kernels)
    planes = {k: n for k, n in kernels.items() if "k3s_planes_kernel" in k}
    assert sorted(planes.values()) == [1, 1]
    for name in ("k1s_riccati_team_kernel", "k3s_rollout_kernel"):
        assert sum(n for k, n in kernels.items() if name in k) == 2


def test_k6_one_team_kernel_per_backward_call(dev):
    """One lqr_backward call runs exactly one device kernel, the team
    kernel (its <true> instantiation for (Q, Qf), <false> for a per-stage
    Q), and never the one-thread riccati_bwd_kernel."""
    kernels = _device_kernels("_k6_calls")
    assert sum(kernels.values()) == 2
    assert not any("riccati_bwd_kernel" in k for k in kernels)
    team = {k: n for k, n in kernels.items() if "riccati_team_kernel" in k}
    assert sorted(team.values()) == [1, 1]
    for tag, mangled in (("<true>", "ILb1E"), ("<false>", "ILb0E")):
        assert sum(tag in k or mangled in k for k in team) == 1


def test_k5_k7a_new_kernels_per_call(dev):
    """One K5 call launches the new design's k5s_stage_kernel and
    k5s_dense_kernel once each, one K7a call k7s_stage_kernel and
    k7s_reduce_kernel once each; the one-thread linearize_kernel and
    merit_alpha_kernel never run."""
    kernels = _device_kernels("_k5_k7a_calls")
    assert not any("linearize_kernel" in k or "merit_alpha_kernel" in k
                   for k in kernels)
    for name in ("k5s_stage_kernel", "k5s_dense_kernel", "k7s_stage_kernel",
                 "k7s_reduce_kernel"):
        assert sum(v for k, v in kernels.items() if name in k) == 1, kernels
    assert sum(kernels.values()) == 4


def test_k2_leaves_inputs_untouched(dev):
    a, src, idx = _k2_inputs(dev, (20, 12), 16384, 4096, "clumpy")
    keep = [a.clone(), src.clone(), idx.clone()]
    permute.take_lanes(a, idx)
    permute.set_lanes(a, src, idx)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(keep[0]))
    assert torch.equal(_bits(src), _bits(keep[1]))
    assert torch.equal(idx, keep[2])


def test_k2_rejects_what_it_cannot_take(dev):
    a, src, idx = _k2_inputs(dev, (3, 12), 4096, 1024, "uniform")
    with pytest.raises(TypeError, match="float32"):
        permute.take_lanes(a.double(), idx)
    with pytest.raises(TypeError, match="float32"):
        permute.set_lanes(a.double(), src.double(), idx)
    with pytest.raises(ValueError, match="1-D"):
        permute.take_lanes(a, idx[None])
    with pytest.raises(ValueError, match="1-D"):
        permute.set_lanes(a, src, idx[None])
    with pytest.raises(ValueError, match="lies on"):
        permute.take_lanes(a, idx.cpu())
    with pytest.raises(ValueError, match="lies on"):
        permute.set_lanes(a, src, idx.cpu())


def test_compacted_solve_is_bitwise_and_launches_kernels(dev):
    B = 8192
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(x0.cpu().numpy()[None]
                          + 0.01 * rng.normal(size=(B, 12)),
                          dtype=torch.float32, device=dev)
    states = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, device=dev), B)
    k2_before = dict(permute.launches)
    st_c, in_c, _ = sharded.solve_batch(params, weights, cfg, states, x0s, x_ref)
    assert permute.launches["take_lanes"] > k2_before["take_lanes"]
    st_f, in_f, _ = sharded.solve_batch(
        params, weights, dataclasses.replace(cfg, compact=False), states, x0s,
        x_ref)
    assert torch.equal(st_c.u, st_f.u) and torch.equal(st_c.x, st_f.x)
    assert torch.equal(in_c.sqp_iters, in_f.sqp_iters)
    assert torch.equal(in_c.status, in_f.status)
    assert int(in_c.converged.sum()) >= 0.95 * B


def _sync_args(dev, B, seed=0):
    """K5 inputs around the benchmark problem, the plain linearization's
    LQR data there, and a K7a direction with a random alpha per scenario."""
    rng = np.random.default_rng(seed)
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    N = cfg.N

    def T(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    xa = T(x0.cpu().numpy()[None, :, None]
           + 0.01 * rng.normal(size=(N + 1, 12, B)))
    us = T(100.0 + rng.normal(size=(N, 12, B)))
    xra = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    Ac, bc = srbd.constraint_matrix(params)
    lin = (params, weights.Q, weights.R, Ac, bc, xa[:-1], xa[1:], us,
           xra[:-1], cfg.mu_barrier, cfg.theta_barrier)
    A, Bm, b, R, q, r, _ = engine._stage_linearization(
        srbd_linearize.linearize_ref, params, weights, cfg, xa, us, xra)
    dx0 = T(0.01 * rng.normal(size=(12, B)))
    lqr = (A, Bm, b, (weights.Q, weights.Qf), R, q, r, dx0, cfg.reg)
    dx = T(0.01 * rng.normal(size=(N + 1, 12, B)))
    du = T(rng.normal(size=(N, 12, B)))
    alpha = T(0.1 + 0.9 * rng.random(B))
    merit = (params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us, xra,
             dx, du, alpha, cfg.mu_barrier, cfg.theta_barrier)
    return lin, lqr, merit


def test_k5_matches_plain(dev):
    lin, _, _ = _sync_args(dev, 4096)
    before = srbd_linearize.launches
    got = srbd_linearize.linearize(*lin)
    torch.cuda.synchronize()
    assert srbd_linearize.launches == before + 1
    ref = srbd_linearize.linearize_ref(*lin)
    for g, r in zip(got[:6], ref[:6]):
        assert torch.isfinite(g).all()
        assert parity_metric(g.cpu().numpy(), r.cpu().numpy()) < 1e-4
    for i in range(8):   # merit partials, one row at a time
        assert parity_metric(got[6][:, i].cpu().numpy(),
                             ref[6][:, i].cpu().numpy()) < 1e-4


def _cut(args, lo, hi, B):
    """``args`` with the tensors at positions lo .. hi - 1 cut to their
    first ``B`` lanes."""
    return tuple(a[..., :B].contiguous() if lo <= i < hi else a
                 for i, a in enumerate(args))


@pytest.mark.parametrize("B", [4096, 4093])
def test_k5_designs_match_plain_bitwise(dev, B):
    """K5 through the new design, through the one-thread yardstick and the
    plain version agree bit for bit on all seven outputs, at B=4096 and at
    a width that is no multiple of a block's 128 lanes."""
    lin = _cut(_sync_args(dev, 4096)[0], 5, 9, B)
    ref = srbd_linearize.linearize_ref(*lin)
    outs = [srbd_linearize._linearize_cuda(*lin, one_thread=one_thread)
            for one_thread in (False, True)]
    torch.cuda.synchronize()
    for got in outs:
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert torch.isfinite(g).all()
            assert torch.equal(_bits(g), _bits(r))


@pytest.mark.parametrize("B", [4096, 4093])
def test_k7a_designs_match_plain_bitwise(dev, B):
    """K7a through the stage pass and the reduction, through the one-thread
    yardstick and the plain version agree bit for bit on theta and phi."""
    merit = _cut(_sync_args(dev, 4096)[2], 6, 12, B)
    ref = merit_kernel.merit_alpha_ref(*merit)
    for one_thread in (False, True):
        got = merit_kernel._merit_alpha_cuda(*merit, one_thread=one_thread)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.isfinite(g).all()
            assert torch.equal(_bits(g), _bits(r))


@pytest.mark.parametrize("const_q", [True, False])
def test_k6_matches_plain(dev, const_q):
    _, (A, Bm, b, Qc, R, q, r, x0, reg), _ = _sync_args(dev, 4096)
    N, B = A.shape[0], A.shape[-1]
    Q = Qc if const_q else torch.cat(
        [Qc[0][None].expand(N, 12, 12), Qc[1][None]])[..., None].expand(
            N + 1, 12, 12, B).contiguous()
    key = "riccati_bwd_constq" if const_q else "riccati_bwd"
    before = dict(riccati_kernel.launches)
    K, k = riccati_kernel.lqr_backward(A, Bm, b, Q, R, q, r, reg)
    x, u = riccati_kernel.lqr_forward(A, Bm, b, K, k, x0)
    torch.cuda.synchronize()
    assert riccati_kernel.launches[key] == before[key] + 1
    assert riccati_kernel.launches["riccati_fwd"] == before["riccati_fwd"] + 1
    K_r, k_r = riccati_kernel.lqr_backward_ref(A, Bm, b, Q, R, q, r, reg)
    x_r, u_r = riccati_kernel.lqr_forward_ref(A, Bm, b, K, k, x0)
    for g, ref in ((K, K_r), (k, k_r), (x, x_r), (u, u_r)):
        assert torch.isfinite(g).all()
        assert parity_metric(g.cpu().numpy(), ref.cpu().numpy()) < 1e-4


def _k6_args(dev, B, const_q):
    """K6's backward arguments (A, B, b, Q, R, q, r, reg) on the benchmark
    problem's LQR data: Q the stage-constant (Q, Qf) (K6a) or a per-stage
    tensor [N+1,12,12,B] of the weights plus a small PSD perturbation per
    stage and scenario (K6b)."""
    _, (A, Bm, b, Qc, R, q, r, _, reg), _ = _sync_args(dev, B)
    N = A.shape[0]
    if const_q:
        Q = Qc
    else:
        Mh = torch.as_tensor(np.random.default_rng(3).normal(
            size=(N + 1, 12, 12, B)), dtype=torch.float32, device=dev)
        Q = (torch.cat([Qc[0][None].expand(N, 12, 12), Qc[1][None]])[..., None]
             + 1e-3 * torch.einsum("nikb,njkb->nijb", Mh, Mh)).contiguous()
    return A, Bm, b, Q, R, q, r, reg


@pytest.mark.parametrize("B", [4096, 4093])
@pytest.mark.parametrize("const_q", [True, False])
def test_k6_team_and_one_thread_match_plain(dev, const_q, B):
    """K6a/K6b's backward pass through the team kernel (the public entry's)
    and through the one-thread yardstick against the plain version, at
    B=4096 and at a width that is not a multiple of a block's 8 teams (a
    ragged edge); the team kernel equal to the one-thread kernel bit for
    bit."""
    A, Bm, b, Q, R, q, r, reg = _k6_args(dev, B, const_q)
    key = "riccati_bwd_constq" if const_q else "riccati_bwd"
    before = riccati_kernel.launches[key]
    team = riccati_kernel.lqr_backward(A, Bm, b, Q, R, q, r, reg)
    one = riccati_kernel._lqr_backward_cuda(A, Bm, b, Q, R, q, r, reg,
                                            one_thread=True)
    torch.cuda.synchronize()
    assert riccati_kernel.launches[key] == before + 2
    ref = riccati_kernel.lqr_backward_ref(A, Bm, b, Q, R, q, r, reg)
    for g, o, r_ in zip(team, one, ref):
        assert torch.isfinite(g).all()
        assert torch.equal(g, o)
        assert parity_metric(g.cpu().numpy(), r_.cpu().numpy()) < 1e-4


def test_k6_backward_rejects_what_it_cannot_take(dev):
    """The public backward entry raises on float64 and on misshapen CUDA
    tensors, the team and one-thread kernels alike."""
    A, Bm, b, Q, R, q, r, reg = _k6_args(dev, 64, True)
    for one_thread in (False, True):
        with pytest.raises(TypeError, match="float32"):
            riccati_kernel._lqr_backward_cuda(A.double(), Bm, b, Q, R, q, r,
                                              reg, one_thread=one_thread)
        with pytest.raises(ValueError, match="shape"):
            riccati_kernel._lqr_backward_cuda(A, Bm, b, Q, R, q, r[..., :-1],
                                              reg, one_thread=one_thread)
    with pytest.raises(ValueError, match="shape"):
        riccati_kernel.lqr_backward(A, Bm[:-1], b, Q, R, q, r, reg)


def test_k7_matches_plain(dev):
    _, _, merit = _sync_args(dev, 4096)
    before = merit_kernel.launches["merit_alpha"]
    got = merit_kernel.merit_alpha(*merit)
    torch.cuda.synchronize()
    assert merit_kernel.launches["merit_alpha"] == before + 1
    ref = merit_kernel.merit_alpha_ref(*merit)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-4)


@pytest.mark.parametrize("kernel", ["linearize", "riccati", "merit"])
def test_new_kernels_reject_float64(dev, kernel):
    lin, lqr, merit = _sync_args(dev, 64)
    with pytest.raises(TypeError, match="float32"):
        if kernel == "linearize":
            srbd_linearize.linearize(*lin[:5], *(t.double() for t in lin[5:9]),
                                     *lin[9:])
        elif kernel == "riccati":
            riccati_kernel.lqr_solve(*(t.double() for t in lqr[:3]), lqr[3],
                                     *(t.double() for t in lqr[4:8]),
                                     reg=lqr[8])
        else:
            merit_kernel.merit_alpha(*merit[:6],
                                     *(t.double() for t in merit[6:12]),
                                     *merit[12:])


def test_sync_pallas_solve_launches_kernels(dev):
    B = 4096
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(x0.cpu().numpy()[None]
                          + 0.01 * rng.normal(size=(B, 12)),
                          dtype=torch.float32, device=dev)
    states = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, device=dev), B)
    before = (srbd_linearize.launches, riccati_kernel.launches[
        "riccati_bwd_constq"], riccati_kernel.launches["riccati_fwd"],
        merit_kernel.launches["merit_alpha"])
    st, info, summ = sharded.solve_batch(
        params, weights, dataclasses.replace(cfg, qp_kernel="pallas"), states,
        x0s, x_ref)
    after = (srbd_linearize.launches, riccati_kernel.launches[
        "riccati_bwd_constq"], riccati_kernel.launches["riccati_fwd"],
        merit_kernel.launches["merit_alpha"])
    assert all(a > b for a, b in zip(after, before))
    assert int(summ.n_converged) >= 0.95 * B
    assert torch.isfinite(st.u[info.converged]).all()


@pytest.mark.parametrize("cand", [True, False])
def test_k3_matches_plain(dev, cand):
    """The public entry (the split kernels) and the private one-thread
    yardstick against the plain version; each call counts one launch."""
    args = _k1_args(dev, 20, 4096, alpha_zero=False)
    head, (xa, us, xra, dxc, duc, alpha, x0s), tail = \
        args[:6], args[6:13], args[13:]
    if cand:
        call = (head + (xa, us, xra, dxc, duc, alpha, x0s) + tail,
                sqp_kernel.sqp_qp_solve_onepass_cand, sqp_kernel._k3a_cuda,
                sqp_kernel.sqp_qp_solve_onepass_cand_ref, "sqp_onepass_cand")
    else:
        call = (head + (xa, us, xra, x0s - xa[0]) + tail,
                sqp_kernel.sqp_qp_solve_onepass, sqp_kernel._k3b_cuda,
                sqp_kernel.sqp_qp_solve_onepass_ref, "sqp_onepass")
    a, kern, private, plain, key = call
    ref = plain(*a, reg=1e-9)
    for run in (lambda: kern(*a, reg=1e-9),
                lambda: private(*a, reg=1e-9, one_thread=False),
                lambda: private(*a, reg=1e-9, one_thread=True)):
        before = dict(sqp_kernel.launches)
        got = run()
        torch.cuda.synchronize()
        assert sqp_kernel.launches[key] == before[key] + 1
        for g, r in zip((*got[:3], *got[3]), (*ref[:3], *ref[3])):
            assert torch.isfinite(g).all()
            assert parity_metric(g.cpu().numpy(), r.cpu().numpy()) < 1e-4


def test_k4_matches_plain(dev):
    args = _k1_args(dev, 20, 4096, alpha_zero=True)
    head, (xa, us, xra), tail = args[:6], args[6:9], args[13:]
    dx0 = args[12] - xa[0]
    before = dict(sqp_kernel.launches)
    prods = sqp_kernel.sqp_qp_backward(*head, xa, us, xra, *tail, reg=1e-9)
    fwd = sqp_kernel.sqp_qp_forward(*prods[:7], dx0)
    torch.cuda.synchronize()
    for key in ("sqp_twopass_bwd", "sqp_twopass_fwd"):
        assert sqp_kernel.launches[key] == before[key] + 1
    ref = sqp_kernel.sqp_qp_backward_ref(*head, xa, us, xra, *tail, reg=1e-9)
    ref_f = sqp_kernel.sqp_qp_forward_ref(*prods[:7], dx0)
    for g, r in zip((*prods[:7], *prods[7], *fwd),
                    (*ref[:7], *ref[7], *ref_f)):
        assert torch.isfinite(g).all()
        assert parity_metric(g.cpu().numpy(), r.cpu().numpy()) < 1e-4


@pytest.mark.parametrize("B", [4096, 4093])
def test_k4a_split_and_one_thread_match_plain(dev, B):
    """K4a through its split kernels (the public entry's) and through the
    one-thread yardstick against the plain version, at B=4096 and at a
    width that is not a multiple of a block's 8 teams: both bit for bit on
    all eleven outputs, each call counted once."""
    args = _k1_args(dev, 20, B, alpha_zero=False)
    bwd = args[:9] + args[13:]
    ref = sqp_kernel.sqp_qp_backward_ref(*bwd, reg=1e-9)
    before = sqp_kernel.launches["sqp_twopass_bwd"]
    outs = [sqp_kernel.sqp_qp_backward(*bwd, reg=1e-9),
            sqp_kernel._k4a_cuda(*bwd, reg=1e-9, one_thread=True)]
    torch.cuda.synchronize()
    assert sqp_kernel.launches["sqp_twopass_bwd"] == before + 2
    for got in outs:
        for g, r in zip((*got[:7], *got[7]), (*ref[:7], *ref[7])):
            assert torch.isfinite(g).all()
            assert torch.equal(g, r)


def test_redesigns_leave_the_other_team_kernels_unchanged(dev):
    """ptxas (registers, spill stores) of the team kernels that the rank-6
    and Acl forms sit beside, as PERF.md records them
    (``chip_smoke.K1S_B_PTXAS``, ``chip_smoke.K6_TEAM_PTXAS``): K1s-B's
    gains and factor forms at 64 registers and 0 B, K6a's and K6b's team
    kernel at 128 and 148 registers and 0 B."""
    import chip_smoke

    from srbd_nmpc_tpu_torch.utils import build

    for name in ("sqp_planes_split", "riccati"):
        build.load_kernel(name)
    got = {}
    for source, needle in (("sqp_planes_split", "k1s_riccati_team_kernel"),
                           ("sqp_planes_split", "k1s_riccati_factor_kernel"),
                           ("riccati", "riccati_team_kernel")):
        for mangled, regs, stores, _, _ in chip_smoke._ptxas(source, needle):
            tag = ("team <true>" if "ILb1E" in mangled else "team <false>"
                   if "ILb0E" in mangled else needle)
            got[tag] = (regs, stores)
    assert got == {"k1s_riccati_team_kernel": chip_smoke.K1S_B_PTXAS,
                   "k1s_riccati_factor_kernel": chip_smoke.K1S_B_PTXAS,
                   **chip_smoke.K6_TEAM_PTXAS}


def test_k3_k4_reject_float64(dev):
    args = _k1_args(dev, 20, 64, alpha_zero=True)
    head, tail = args[:6], args[13:]
    xa, us, xra, x0s = (args[i].double() for i in (6, 7, 8, 12))
    with pytest.raises(TypeError, match="float32"):
        sqp_kernel.sqp_qp_solve_onepass(*head, xa, us, xra, x0s - xa[0],
                                        *tail, reg=1e-9)
    with pytest.raises(TypeError, match="float32"):
        sqp_kernel.sqp_qp_backward(*head, xa, us, xra, *tail, reg=1e-9)


@pytest.mark.parametrize("speculative", [True, False])
def test_dense_solve_launches_kernels(dev, speculative):
    """planes=False on both loops: the speculative loop launches K3b once
    and K3a on every trip (compaction bitwise), the synchronous one K3b and
    K7a; both converge like the planes path."""
    B = 8192
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    cfg = dataclasses.replace(cfg, planes=False, speculative=speculative,
                              qp_kernel="fused")
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(x0.cpu().numpy()[None]
                          + 0.01 * rng.normal(size=(B, 12)),
                          dtype=torch.float32, device=dev)
    states = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, device=dev), B)
    before = (dict(sqp_kernel.launches), merit_kernel.launches["merit_alpha"],
              dict(sqp_planes.launches))
    st, info, summ = sharded.solve_batch(params, weights, cfg, states, x0s, x_ref)
    k3 = {k: v - before[0][k] for k, v in sqp_kernel.launches.items()}
    assert sqp_planes.launches == before[2]
    if speculative:
        assert k3["sqp_onepass"] == 1
        assert k3["sqp_onepass_cand"] == int(info.ls_trips[0]) - 1
        st_f, in_f, _ = sharded.solve_batch(
            params, weights, dataclasses.replace(cfg, compact=False), states,
            x0s, x_ref)
        assert torch.equal(st.u, st_f.u) and torch.equal(st.x, st_f.x)
        assert torch.equal(info.sqp_iters, in_f.sqp_iters)
    else:
        assert k3["sqp_onepass"] == int(info.sqp_iters.max())
        assert merit_kernel.launches["merit_alpha"] > before[1]
    assert int(summ.n_converged) >= 0.95 * B
    assert torch.isfinite(st.u[info.converged]).all()


@pytest.mark.parametrize("with_grad", [True, False])
def test_k7b_matches_plain(dev, with_grad):
    """K7b at N=20, B=4096 on random iterates (x ~ 0.1 N(0,1),
    u ~ 90 + 20 N(0,1)): every output within 1e-4 of the plain version
    (bitwise expected, as K7a)."""
    rng = np.random.default_rng(3)
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    _, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    N, B = cfg.N, 4096
    x = torch.as_tensor(0.1 * rng.normal(size=(N + 1, 12, B)),
                        dtype=torch.float32, device=dev)
    u = torch.as_tensor(90 + 20 * rng.normal(size=(N, 12, B)),
                        dtype=torch.float32, device=dev)
    xr = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    Ac, bc = srbd.constraint_matrix(params)
    args = (params, weights.Q, weights.Qf, weights.R, Ac, bc, x, u, xr,
            cfg.mu_barrier, cfg.theta_barrier)
    key = "merit" if with_grad else "merit_nograd"
    before = merit_kernel.launches[key]
    got = merit_kernel.merit(*args, with_grad=with_grad)
    torch.cuda.synchronize()
    assert merit_kernel.launches[key] == before + 1
    ref = merit_kernel.merit_ref(*args, with_grad=with_grad)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        assert torch.isfinite(g).all()
        assert parity_metric(g.cpu().numpy(), r.cpu().numpy()) < 1e-4
    with pytest.raises(TypeError, match="float32"):
        merit_kernel.merit(*args[:6], x.double(), u.double(), xr.double(),
                           *args[9:], with_grad=with_grad)


@pytest.mark.parametrize("speculative", [True, False])
def test_park_factor_solve_launches_the_factor_body(dev, speculative):
    """park_factor=True on both loops runs K1's factor body on every K1
    trip and converges like the default; the speculative solve's
    compaction stays bitwise."""
    B = 8192
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    cfg = dataclasses.replace(cfg, park_factor=True, speculative=speculative)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(x0.cpu().numpy()[None]
                          + 0.01 * rng.normal(size=(B, 12)),
                          dtype=torch.float32, device=dev)
    states = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, device=dev), B)
    before = dict(sqp_planes.launches)
    st, info, summ = sharded.solve_batch(params, weights, cfg, states, x0s, x_ref)
    k1 = {k: v - before[k] for k, v in sqp_planes.launches.items()}
    if speculative:
        assert k1 == {"gains": 0, "rank6": 0,
                      "factor": int(info.ls_trips[0])}
        st_f, in_f, _ = sharded.solve_batch(
            params, weights, dataclasses.replace(cfg, compact=False), states,
            x0s, x_ref)
        assert torch.equal(st.u, st_f.u) and torch.equal(st.x, st_f.x)
        assert torch.equal(info.sqp_iters, in_f.sqp_iters)
        assert torch.equal(info.status, in_f.status)
    else:
        assert k1 == {"gains": 0, "rank6": 0,
                      "factor": int(info.sqp_iters.max())}
    assert int(summ.n_converged) >= 0.95 * B
    assert torch.isfinite(st.u[info.converged]).all()


def test_merit_fast_takes_the_plain_merit_for_float64(dev):
    """Under ``qp_kernel="auto"`` a float64 CUDA batch takes the plain merit
    (K7b is float32) and launches no kernel."""
    params, weights, cfg = build_from_options(MpcOptions.default(),
                                              dtype=torch.float64, device=dev)
    _, x_ref = engine.make_benchmark_problem(cfg, torch.float64, device=dev)
    assert cfg.qp_kernel == "auto"
    st = sharded.broadcast_state(
        engine.NmpcState.initial(cfg.N, torch.float64, device=dev), 1024)
    before = dict(merit_kernel.launches)
    for g in (True, False):
        out = engine._merit_fast(params, weights, cfg, st.x, st.u, x_ref,
                                 with_grad=g)
        ref = engine.merit(params, weights, cfg, st.x, st.u, x_ref,
                           with_grad=g)
        torch.cuda.synchronize()
        assert len(out) == (6 if g else 4)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert merit_kernel.launches == before


def test_merit_fast_launches_k7b(dev):
    """``engine._merit_fast`` on a batch with a shared reference and
    ``qp_kernel="auto"`` launches K7b's variant for ``with_grad``."""
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    _, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    B = 1024
    st = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, device=dev), B)
    for g, key in ((True, "merit"), (False, "merit_nograd")):
        before = dict(merit_kernel.launches)
        out = engine._merit_fast(params, weights, cfg, st.x, st.u, x_ref,
                                 with_grad=g)
        torch.cuda.synchronize()
        assert merit_kernel.launches[key] == before[key] + 1
        assert len(out) == (6 if g else 4)
        assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_scenario_solve_on_the_card(dev, dtype):
    """The single-scenario solve runs on CUDA tensors (no kernel; f64 and
    f32) like on the CPU: same iterations, status and trips, u within
    1e-8 (f64) or 2.5e-4 (f32 with one refinement pass)."""
    def run(device):
        cfg = engine.NmpcConfig(refine=0 if dtype == torch.float64 else 1)
        params = srbd.SRBDParams.create(dt=0.015, dtype=dtype, device=device)
        weights = engine.NmpcWeights.create(
            [0] * 11 + [10], 1e-4,
            [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], cfg.N,
            dtype, device=device)
        x0, x_ref = engine.make_benchmark_problem(cfg, dtype, device=device)
        return engine.solve(params, weights, cfg,
                            engine.NmpcState.initial(cfg.N, dtype,
                                                     device=device),
                            x0, x_ref)

    st, info = run(dev)
    st_c, info_c = run("cpu")
    assert st.u.device.type == "cuda" and torch.isfinite(st.u).all()
    for name in ("sqp_iters", "status", "ls_trips"):
        assert int(getattr(info, name)) == int(getattr(info_c, name))
    # f32: a lost refinement pass or a lower precision fails here (u ~100 N;
    # the card measured 2.3e-05 N from the CPU)
    tol = 1e-8 if dtype == torch.float64 else 2.5e-4
    assert float((st.u.cpu() - st_c.u).abs().max()) < tol
