"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``srbd_nmpc_tpu_torch/csrc``, checks each
against its plain PyTorch version at the main path's shapes, then drives the
port's main path (``parallel.sharded.solve_batch``, the default NmpcConfig:
N=20, speculative fused SQP trips, compaction tiers (2, 8, 32)) on a cold and
a warm B=131072 solve, and checks the results: convergence, compaction
bitwise on the card, the kernel path against the plain path on the CPU, and
the independent f64 C++ oracle (``native/srbd_oracle.cpp``). Phases 10-12 do
the same for the iteration-synchronous loop: its kernels (K5, K6, K7a)
against their plain versions, cold B=131072 solves on its ``pallas`` and
``fused`` routes against the speculative path, and each kernel route against
the plain ``xla`` route. Each path's launch counts are set to 0 just before
it is driven and read just after.

Every phase prints one line and raises on failure (non-zero exit). The line
before the last is the card's ``nvidia-smi`` name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card the script
exits non-zero before any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 131072
N_MAIN = 20
REL_TOL = 1e-4
ORACLE_TOL = 1e-3
SOURCES = ("permute", "sqp_planes", "linearize", "riccati", "merit")
# the synchronous routes: converged within 0.5 % of B and mean SQP
# iterations within 0.1 of the speculative path's cold solve
SYNC_ROUTES = {"pallas": dict(qp_kernel="pallas"),
               "fused": dict(qp_kernel="fused", speculative=False)}
SYNC_CONV_FRAC = 0.005
SYNC_ITER_TOL = 0.1
PARITY_FLIP_FRAC = 0.005


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sorted_idx(rng, B, Bc, clumpy):
    if clumpy:
        p = np.ones(B)
        p[: B // 3] = 8.0
        p[-B // 5:] = 0.05
        p /= p.sum()
        return np.sort(rng.choice(B, size=Bc, replace=False, p=p))
    return np.sort(rng.choice(B, size=Bc, replace=False))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1 device] {name} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | nvidia-smi: {smi}", flush=True)
    return name, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from srbd_nmpc_tpu_torch.utils import build

    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))
    spills = {}
    for name in SOURCES:
        build.load_kernel(name)
        lines = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "spill" in ln or "registers" in ln]
        spills[name] = lines
    secs = time.perf_counter() - t0
    print(f"[2 build] {len(SOURCES)} sources built in parallel and loaded in "
          f"{secs:.1f} s", flush=True)
    for name, lines in spills.items():
        for ln in lines:
            print(f"[2 build] {name}: {ln}", flush=True)
    return secs


def phase_permute(dev):
    from srbd_nmpc_tpu_torch.ops import permute

    rng = np.random.default_rng(3)
    shape = (N_MAIN + 1, 12, B_MAIN)
    a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)
    for Bc in (65536, 4096):
        for clumpy in (False, True):
            idx = torch.as_tensor(_sorted_idx(rng, B_MAIN, Bc, clumpy),
                                  device=dev)
            got = permute.take_lanes(a, idx)
            ref = permute.take_lanes_ref(a, idx)
            src = torch.as_tensor(rng.normal(size=shape[:-1] + (Bc,)),
                                  dtype=torch.float32, device=dev)
            got_s = permute.set_lanes(a, src, idx)
            ref_s = permute.set_lanes_ref(a, src, idx)
            torch.cuda.synchronize()
            if not (torch.equal(got, ref) and torch.equal(got_s, ref_s)):
                raise AssertionError(f"K2 not bitwise at Bc={Bc} clumpy={clumpy}")
    # time at the first tier crossing of the main path: [21,12,B] -> B/2
    idx = torch.as_tensor(_sorted_idx(rng, B_MAIN, B_MAIN // 2, False),
                          device=dev)
    src = permute.take_lanes_ref(a, idx)
    t = {
        "take_lanes": (_cuda_ms(lambda: permute.take_lanes(a, idx), 20),
                       _cuda_ms(lambda: permute.take_lanes_ref(a, idx), 20)),
        "set_lanes": (_cuda_ms(lambda: permute.set_lanes(a, src, idx), 20),
                      _cuda_ms(lambda: permute.set_lanes_ref(a, src, idx), 20)),
    }
    print("[3 K2] take_lanes/set_lanes bitwise equal to plain on "
          f"{list(shape)} at 65536 and 4096 lanes, uniform and clumpy; "
          f"[21,12,131072]->65536: take {t['take_lanes'][0]:.4f} ms "
          f"(plain {t['take_lanes'][1]:.4f}), set {t['set_lanes'][0]:.4f} ms "
          f"(plain {t['set_lanes'][1]:.4f})", flush=True)
    return t


def _k1_inputs(rng, N, B, dev, alpha_zero):
    from srbd_nmpc_tpu_torch.models import srbd
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

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
            dxc, duc, alpha, x0s, cfg.mu_barrier, cfg.theta_barrier), cfg.reg


def phase_k1(dev):
    from srbd_nmpc_tpu_torch.ops import sqp_planes
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    rng = np.random.default_rng(0)
    worst = {"dx": 0.0, "du": 0.0, "dphi": 0.0, "theta": 0.0, "phi": 0.0}
    max_abs = 0.0
    for alpha_zero in (True, False):
        args, reg = _k1_inputs(rng, N_MAIN, 4096, dev, alpha_zero)
        got = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=reg)
        ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg)
        torch.cuda.synchronize()
        for i, key in enumerate(("dx", "du", "dphi")):
            g, r = got[i].cpu().numpy(), ref[i].cpu().numpy()
            if not np.all(np.isfinite(g)):
                raise AssertionError(f"K1 {key} not finite")
            worst[key] = max(worst[key], parity_metric(g, r))
            max_abs = max(max_abs, float(np.max(np.abs(g - r))))
        for i, key in ((0, "theta"), (1, "phi")):
            g = got[3][i].cpu().numpy().astype(np.float64)
            r = ref[3][i].cpu().numpy().astype(np.float64)
            worst[key] = max(worst[key], float(np.max(np.abs(g - r)
                                                      / np.abs(r))))
    print("[4 K1] kernel vs plain at N=20, B=4096, alpha=0 and random alpha: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit {REL_TOL:g}); max |diff| {max_abs:.3e}", flush=True)
    if not all(v < REL_TOL for v in worst.values()):
        raise AssertionError(f"K1 disagrees with its plain version: {worst}")

    # times at the main path's widths: full width and the three tiers
    times = {}
    for B in (B_MAIN, B_MAIN // 2, B_MAIN // 8, B_MAIN // 32):
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        times[B] = _cuda_ms(
            lambda: sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=reg), 5)
    args, reg = _k1_inputs(rng, N_MAIN, B_MAIN, dev, False)
    plain_ms = _cuda_ms(
        lambda: sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg), 1)
    del args
    torch.cuda.empty_cache()
    print("[4 K1] ms per launch: " + ", ".join(
        f"B={B} {ms:.3f}" for B, ms in times.items())
        + f"; plain at B={B_MAIN}: {plain_ms:.3f} ms", flush=True)
    return max_abs, times, plain_ms


def _cold_problem(B, dev, seed=0, compact=True):
    import dataclasses

    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.parallel import sharded
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    cfg = dataclasses.replace(cfg, compact=compact)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(x0.cpu().numpy()[None]
                          + 0.01 * rng.normal(size=(B, 12)),
                          dtype=torch.float32, device=dev)
    states = sharded.broadcast_state(
        engine.NmpcState.initial(cfg.N, device=dev), B)
    return params, weights, cfg, states, x0s, x_ref


def phase_cold(dev, card):
    from srbd_nmpc_tpu_torch.ops import permute, sqp_planes
    from srbd_nmpc_tpu_torch.parallel import sharded

    prob = _cold_problem(B_MAIN, dev)
    torch.cuda.synchronize()
    sqp_planes.launches = 0
    for k in permute.launches:
        permute.launches[k] = 0
    st, info, summ = sharded.solve_batch(*prob)
    torch.cuda.synchronize()
    launches = {"sqp_planes": sqp_planes.launches, **permute.launches}

    n_conv = int(summ.n_converged)
    conv = info.converged
    u_ok = bool(torch.isfinite(st.u[conv]).all())
    trips = int(info.ls_trips[0])
    mean_it = float(summ.mean_iters)
    print(f"[5 cold] B={B_MAIN}: converged {n_conv}/{B_MAIN}, mean SQP "
          f"iterations {mean_it:.4f}, trips {trips}, launches {launches}",
          flush=True)
    if n_conv < 0.95 * B_MAIN:
        raise AssertionError(f"cold solve converged {n_conv} < 95 %")
    if not u_ok:
        raise AssertionError("a converged cold solution is not finite")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    times = []
    sharded.solve_batch(*prob)
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        sharded.solve_batch(*prob)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(times, 50))
    print(f"[5 cold] p50 {p50:.3f} ms per B={B_MAIN} solve, "
          f"{B_MAIN / p50 * 1e3:.1f} solves/s (times {[round(t, 3) for t in times]}) "
          f"on {card}", flush=True)
    return st, info, prob, launches, (n_conv, mean_it)


def phase_warm(dev, st_cold, prob):
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.parallel import sharded

    params, weights, cfg, _, _, x_ref = prob
    x0s_w = st_cold.x[:, 1, :].contiguous()
    st1, info1, s1 = sharded.solve_batch(params, weights, cfg,
                                         engine.shift_state(st_cold), x0s_w,
                                         x_ref)
    st2, info2, s2 = sharded.solve_batch(params, weights, cfg,
                                         engine.shift_state(st1), x0s_w, x_ref)
    torch.cuda.synchronize()
    for tag, st, s in (("cycle 1", st1, s1), ("repetition", st2, s2)):
        if not (torch.isfinite(st.u).all() and torch.isfinite(st.x).all()):
            raise AssertionError(f"warm {tag} solution not finite")
    print(f"[6 warm] cycle 1: converged {int(s1.n_converged)}/{B_MAIN}, mean "
          f"iterations {float(s1.mean_iters):.4f}; fed-back repetition: "
          f"converged {int(s2.n_converged)}/{B_MAIN}, mean iterations "
          f"{float(s2.mean_iters):.4f}", flush=True)


def phase_compaction(dev):
    from srbd_nmpc_tpu_torch.parallel import sharded

    B = 8192
    st_c, in_c, _ = sharded.solve_batch(*_cold_problem(B, dev, compact=True))
    st_f, in_f, _ = sharded.solve_batch(*_cold_problem(B, dev, compact=False))
    torch.cuda.synchronize()
    same = (torch.equal(st_c.u, st_f.u) and torch.equal(st_c.x, st_f.x)
            and torch.equal(in_c.sqp_iters, in_f.sqp_iters)
            and torch.equal(in_c.status, in_f.status))
    print(f"[7 compaction] B={B}: compact=True vs compact=False bitwise "
          f"equal: {same}", flush=True)
    if not same:
        raise AssertionError("compacted solve differs from the full-width one")


def phase_plain_solve(dev):
    from srbd_nmpc_tpu_torch.parallel import sharded
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    B = 4096
    st_g, in_g, _ = sharded.solve_batch(*_cold_problem(B, dev, seed=42))
    t0 = time.perf_counter()
    st_c, in_c, _ = sharded.solve_batch(*_cold_problem(B, "cpu", seed=42))
    cpu_s = time.perf_counter() - t0
    both = (in_g.converged.cpu() & in_c.converged).numpy()
    # a scenario whose theta ends within f32 rounding of the convergence
    # threshold (theta < 1e-6) may stop one SQP iteration earlier on one
    # device than on the other: its u then differs by a whole SQP step.
    # Such threshold flips are counted (at most 0.1 % of the batch); the
    # accuracy bar holds on the scenarios that stopped at the same iterate.
    same = both & (in_g.sqp_iters.cpu() == in_c.sqp_iters).numpy()
    flips = int(both.sum() - same.sum())
    err = parity_metric(st_g.u.cpu().numpy()[same], st_c.u.numpy()[same])
    err_all = parity_metric(st_g.u.cpu().numpy()[both], st_c.u.numpy()[both])
    print(f"[8 plain] B={B}: CUDA kernels converged "
          f"{int(in_g.converged.sum())}, CPU plain converged "
          f"{int(in_c.converged.sum())}, both {int(both.sum())}, of which "
          f"{flips} stopped at another iteration; relative u error "
          f"{err:.3e} over the {int(same.sum())} at the same iterate (limit "
          f"{REL_TOL:g}), {err_all:.3e} over all; CPU solve {cpu_s:.1f} s",
          flush=True)
    if not (same.sum() > 0 and err < REL_TOL and flips <= B // 1000):
        raise AssertionError(f"kernel path vs plain path: {err}, "
                             f"{flips} iteration flips")


def phase_oracle(st, info, prob):
    from srbd_nmpc_tpu_torch.utils.metrics import oracle_errors

    idx = np.flatnonzero(info.converged.cpu().numpy())[:64]
    x0s = prob[4].cpu().numpy()[idx]
    err = oracle_errors(st.u.cpu().numpy()[idx], x0s)
    print(f"[9 oracle] {len(idx)} converged B={B_MAIN} scenarios vs the f64 "
          f"C++ oracle: relative u error {err:.3e} (limit {ORACLE_TOL:g})",
          flush=True)
    if not (0.0 <= err < ORACLE_TOL):
        raise AssertionError(f"oracle error {err}")


def _reset_counts():
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize
    from srbd_nmpc_tpu_torch.ops import permute, riccati_kernel, sqp_planes

    sqp_planes.launches = 0
    srbd_linearize.launches = 0
    merit_kernel.launches = 0
    for d in (permute.launches, riccati_kernel.launches):
        for k in d:
            d[k] = 0


def _counts():
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize
    from srbd_nmpc_tpu_torch.ops import permute, riccati_kernel, sqp_planes

    return {"sqp_planes": sqp_planes.launches, **permute.launches,
            "linearize": srbd_linearize.launches, **riccati_kernel.launches,
            "merit_alpha": merit_kernel.launches}


def _sync_kernel_inputs(rng, B, dev):
    """Inputs of K5, K6 and K7a around the benchmark problem: states
    x0 + 0.01 N(0,1) at every stage, inputs at the cold start u = 100 plus
    N(0,1), the benchmark reference; the LQR data is the plain K5's
    linearization there, and the K7a direction is the plain LQR solution
    with a random alpha per scenario."""
    from srbd_nmpc_tpu_torch.models import srbd, srbd_linearize
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.ops import riccati_kernel
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

    N = N_MAIN
    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)

    def T(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    x0n = x0.cpu().numpy()
    xa = T(x0n[None, :, None] + 0.01 * rng.normal(size=(N + 1, 12, B)))
    us = T(100.0 + rng.normal(size=(N, 12, B)))
    xra = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    x0s = T(x0n[:, None] + 0.01 * rng.normal(size=(12, B)))
    Ac, bc = srbd.constraint_matrix(params)
    lin_args = (params, weights.Q, weights.R, Ac, bc, xa[:-1], xa[1:], us,
                xra[:-1], cfg.mu_barrier, cfg.theta_barrier)
    A, Bm, b, R, q, r, _ = engine._stage_linearization(
        srbd_linearize.linearize_ref, params, weights, cfg, xa, us, xra)
    # per-stage Q (K6b): the weights plus a small PSD perturbation per
    # stage and scenario
    Mh = T(rng.normal(size=(N + 1, 12, 12, B)))
    Qs = (torch.cat([weights.Q[None].expand(N, 12, 12),
                     weights.Qf[None]])[..., None]
          + 1e-3 * torch.einsum("nikb,njkb->nijb", Mh, Mh)).contiguous()
    del Mh
    dx0s = x0s - xa[0]
    lqr = dict(A=A, B=Bm, b=b, R=R, q=q, r=r, Qc=(weights.Q, weights.Qf),
               Qs=Qs, x0=dx0s, reg=cfg.reg)
    K, k = riccati_kernel.lqr_backward_ref(A, Bm, b, lqr["Qc"], R, q, r,
                                           cfg.reg)
    dx_rest, du = riccati_kernel.lqr_forward_ref(A, Bm, b, K, k, dx0s)
    alpha = T(0.1 + 0.9 * rng.random(B))
    merit_args = (params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us,
                  xra, torch.cat([dx0s[None], dx_rest]), du, alpha,
                  cfg.mu_barrier, cfg.theta_barrier)
    return lin_args, lqr, (K, k), merit_args


def phase_sync_kernels(dev):
    """K5, K6 (const-Q and per-stage Q backward, forward) and K7a against
    their plain versions at N=20, B=4096; then ms per launch at B=131072,
    kernel and plain."""
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize
    from srbd_nmpc_tpu_torch.ops import riccati_kernel as rk
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    rng = np.random.default_rng(10)
    lin_args, lqr, (K_ref, k_ref), merit_args = _sync_kernel_inputs(rng, 4096,
                                                                    dev)
    L, Qc, Qs = lqr, lqr["Qc"], lqr["Qs"]
    pairs = {
        "linearize": (srbd_linearize.linearize(*lin_args),
                      srbd_linearize.linearize_ref(*lin_args)),
        "riccati_bwd_constq": (
            rk.lqr_backward(L["A"], L["B"], L["b"], Qc, L["R"], L["q"],
                            L["r"], L["reg"]), (K_ref, k_ref)),
        "riccati_bwd": (
            rk.lqr_backward(L["A"], L["B"], L["b"], Qs, L["R"], L["q"],
                            L["r"], L["reg"]),
            rk.lqr_backward_ref(L["A"], L["B"], L["b"], Qs, L["R"], L["q"],
                                L["r"], L["reg"])),
        "riccati_fwd": (
            rk.lqr_forward(L["A"], L["B"], L["b"], K_ref, k_ref, L["x0"]),
            rk.lqr_forward_ref(L["A"], L["B"], L["b"], K_ref, k_ref, L["x0"])),
        "merit_alpha": (merit_kernel.merit_alpha(*merit_args),
                        merit_kernel.merit_alpha_ref(*merit_args)),
    }
    torch.cuda.synchronize()
    rel, max_abs = {}, {}
    for name, (got, ref) in pairs.items():
        rel[name] = max_abs[name] = 0.0
        for g, r in zip(got, ref):
            g = g.cpu().numpy().astype(np.float64)
            r = r.cpu().numpy().astype(np.float64)
            if not np.all(np.isfinite(g)):
                raise AssertionError(f"{name}: kernel output not finite")
            if name == "linearize" and g.ndim == 3 and g.shape[1] == 8:
                # merit partials: one row at a time (their scales differ)
                e = max(parity_metric(g[:, i], r[:, i]) for i in range(8))
            elif name == "merit_alpha":
                e = float(np.max(np.abs(g - r) / np.abs(r)))
            else:
                e = parity_metric(g, r)
            rel[name] = max(rel[name], e)
            max_abs[name] = max(max_abs[name], float(np.max(np.abs(g - r))))
    del pairs
    print("[10 kernels] kernel vs plain at N=20, B=4096: " + ", ".join(
        f"{k} {v:.3e}" for k, v in rel.items()) + f" (limit {REL_TOL:g}); "
        "max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items()),
        flush=True)
    if not all(v < REL_TOL for v in rel.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {rel}")

    lin_args, L, (K, k), merit_args = _sync_kernel_inputs(rng, B_MAIN, dev)
    Qc, Qs = L["Qc"], L["Qs"]
    bwd = (L["A"], L["B"], L["b"])
    calls = {
        "linearize": (lambda: srbd_linearize.linearize(*lin_args),
                      lambda: srbd_linearize.linearize_ref(*lin_args)),
        "riccati_bwd_constq": (
            lambda: rk.lqr_backward(*bwd, Qc, L["R"], L["q"], L["r"], L["reg"]),
            lambda: rk.lqr_backward_ref(*bwd, Qc, L["R"], L["q"], L["r"],
                                        L["reg"])),
        "riccati_bwd": (
            lambda: rk.lqr_backward(*bwd, Qs, L["R"], L["q"], L["r"], L["reg"]),
            lambda: rk.lqr_backward_ref(*bwd, Qs, L["R"], L["q"], L["r"],
                                        L["reg"])),
        "riccati_fwd": (lambda: rk.lqr_forward(*bwd, K, k, L["x0"]),
                        lambda: rk.lqr_forward_ref(*bwd, K, k, L["x0"])),
        "merit_alpha": (lambda: merit_kernel.merit_alpha(*merit_args),
                        lambda: merit_kernel.merit_alpha_ref(*merit_args)),
    }
    times = {name: (_cuda_ms(kern, 5), _cuda_ms(plain, 1))
             for name, (kern, plain) in calls.items()}
    del calls, lin_args, L, K, k, merit_args
    torch.cuda.empty_cache()
    print(f"[10 kernels] ms per launch at B={B_MAIN}, kernel (plain): "
          + ", ".join(f"{k} {t[0]:.3f} ({t[1]:.3f})" for k, t in times.items()),
          flush=True)
    return rel, max_abs, times


def _route_problem(dev, B, kw, seed=0):
    import dataclasses

    params, weights, cfg, states, x0s, x_ref = _cold_problem(B, dev, seed=seed)
    return params, weights, dataclasses.replace(cfg, **kw), states, x0s, x_ref


def phase_sync(dev, card, spec):
    """Cold B=131072 solves of the iteration-synchronous loop on its two
    kernel routes, each read against the speculative path's cold solve."""
    from srbd_nmpc_tpu_torch.parallel import sharded

    n_spec, it_spec = spec
    need = {"pallas": ("linearize", "riccati_bwd_constq", "riccati_fwd",
                       "merit_alpha"),
            "fused": ("sqp_planes", "merit_alpha")}
    out = {}
    for route, kw in SYNC_ROUTES.items():
        prob = _route_problem(dev, B_MAIN, kw)
        torch.cuda.synchronize()
        _reset_counts()
        st, info, summ = sharded.solve_batch(*prob)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _counts().items() if v}
        n_conv, mean_it = int(summ.n_converged), float(summ.mean_iters)
        loops = int(info.sqp_iters.max())
        ls = int(info.ls_trips[0])
        # one read-back per SQP loop test and per line-search loop test
        syncs = (loops + (loops < prob[2].sqp_max_iter)) + (ls + loops)
        u_ok = bool(torch.isfinite(st.u[info.converged]).all())
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sharded.solve_batch(*prob)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.percentile(times, 50))
        d_conv, d_it = n_conv - n_spec, mean_it - it_spec
        print(f"[11 sync] {route} (qp_kernel={kw['qp_kernel']!r}, speculative="
              f"{kw.get('speculative', True)}) B={B_MAIN}: converged "
              f"{n_conv}/{B_MAIN} ({d_conv:+d} vs speculative), mean SQP "
              f"iterations {mean_it:.4f} ({d_it:+.4f}), SQP loops {loops}, "
              f"line-search trips {ls}, host syncs {syncs}, launches "
              f"{launches}; p50 {p50:.3f} ms per solve, "
              f"{B_MAIN / p50 * 1e3:.1f} solves/s (times "
              f"{[round(t, 3) for t in times]}) on {card}", flush=True)
        missing = [k for k in need[route] if not launches.get(k)]
        if missing:
            raise AssertionError(f"{route}: kernels never launched: {missing}")
        if not u_ok:
            raise AssertionError(f"{route}: a converged solution is not finite")
        if abs(d_conv) > SYNC_CONV_FRAC * B_MAIN or abs(d_it) > SYNC_ITER_TOL:
            raise AssertionError(f"{route}: converged {d_conv:+d}, mean "
                                 f"iterations {d_it:+.4f} vs speculative")
        out[route] = dict(launches=launches, n_conv=n_conv, mean_it=mean_it,
                          ls=ls, syncs=syncs, p50=p50)
        del prob, st, info
        torch.cuda.empty_cache()

    # the LQR entry with a per-stage Q, as a caller of lqr_solve passes it
    # (the engine always passes (Q, Qf)): K6b's own path
    from srbd_nmpc_tpu_torch.ops import riccati_kernel

    _, L, _, _ = _sync_kernel_inputs(np.random.default_rng(11), B_MAIN, dev)
    torch.cuda.synchronize()
    _reset_counts()
    x, u = riccati_kernel.lqr_solve(L["A"], L["B"], L["b"], L["Qs"], L["R"],
                                    L["q"], L["r"], L["x0"], reg=L["reg"])
    torch.cuda.synchronize()
    lqr_launches = {k: v for k, v in _counts().items() if v}
    ok = bool(torch.isfinite(x).all() and torch.isfinite(u).all())
    del L, x, u
    torch.cuda.empty_cache()
    print(f"[11 sync] lqr_solve with per-stage Q [21,12,12,{B_MAIN}]: "
          f"finite {ok}, launches {lqr_launches}", flush=True)
    if not ok or not lqr_launches.get("riccati_bwd"):
        raise AssertionError(f"per-stage-Q LQR solve: finite {ok}, "
                             f"launches {lqr_launches}")
    out["lqr_per_stage_q"] = dict(launches=lqr_launches)
    return out


def phase_parity(dev):
    """The JAX bench's parity gate on the card at B=4096: each kernel route
    against the plain ``xla`` route."""
    from srbd_nmpc_tpu_torch.parallel import sharded
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    B = 4096
    routes = {"fused+spec": dict(), "fused": SYNC_ROUTES["fused"],
              "pallas": SYNC_ROUTES["pallas"]}
    st_x, in_x, _ = sharded.solve_batch(
        *_route_problem(dev, B, dict(qp_kernel="xla"), seed=7))
    u_x = st_x.u.cpu().numpy()
    res = {}
    for name, kw in routes.items():
        st, inf, _ = sharded.solve_batch(*_route_problem(dev, B, kw, seed=7))
        both = (inf.converged & in_x.converged).cpu().numpy()
        same = both & (inf.sqp_iters == in_x.sqp_iters).cpu().numpy()
        flips = int(both.sum() - same.sum())
        err = parity_metric(st.u.cpu().numpy()[same], u_x[same])
        res[name] = (err, flips, int(same.sum()))
    torch.cuda.synchronize()
    print(f"[12 parity] B={B} vs the plain xla route (converged "
          f"{int(in_x.converged.sum())}): " + ", ".join(
              f"{k} {e:.3e} over {n} at the same iterate, {f} flips"
              for k, (e, f, n) in res.items())
          + f" (limits {REL_TOL:g}, {int(PARITY_FLIP_FRAC * B)} flips)",
          flush=True)
    for k, (e, f, n) in res.items():
        if not (n > 0 and e < REL_TOL and f <= PARITY_FLIP_FRAC * B):
            raise AssertionError(f"parity {k}: {e} over {n}, {f} flips")
    return res


def main() -> int:
    card, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    k2_t = phase_permute(dev)
    k1_err, k1_t, k1_plain = phase_k1(dev)
    st, info, prob, launches, spec = phase_cold(dev, f"{smi}")
    phase_warm(dev, st, prob)
    phase_compaction(dev)
    phase_plain_solve(dev)
    phase_oracle(st, info, prob)
    del st, info, prob
    torch.cuda.empty_cache()
    _, k_err, k_t = phase_sync_kernels(dev)
    sync = phase_sync(dev, f"{smi}", spec)
    phase_parity(dev)

    pallas = sync["pallas"]["launches"]
    per_stage_q = sync["lqr_per_stage_q"]["launches"]
    kernels = [
        {"name": "sqp_planes", "route": "cuda",
         "source": "srbd_nmpc_tpu_torch/csrc/sqp_planes.cu",
         "replaces": "srbd_nmpc_tpu/ops/sqp_planes.py:301",
         "launches": launches["sqp_planes"], "max_abs_err": k1_err,
         "ms": k1_t[B_MAIN], "plain_ms": k1_plain},
        {"name": "take_lanes", "route": "cuda",
         "source": "srbd_nmpc_tpu_torch/csrc/permute.cu",
         "replaces": "srbd_nmpc_tpu/ops/permute_pallas.py:48",
         "launches": launches["take_lanes"], "max_abs_err": 0.0,
         "ms": k2_t["take_lanes"][0], "plain_ms": k2_t["take_lanes"][1]},
        {"name": "set_lanes", "route": "cuda",
         "source": "srbd_nmpc_tpu_torch/csrc/permute.cu",
         "replaces": "srbd_nmpc_tpu/ops/permute_pallas.py:149",
         "launches": launches["set_lanes"], "max_abs_err": 0.0,
         "ms": k2_t["set_lanes"][0], "plain_ms": k2_t["set_lanes"][1]},
    ]
    for name, source, replaces, n in (
            ("linearize", "linearize.cu", "models/srbd_pallas.py:35",
             pallas["linearize"]),
            ("riccati_bwd_constq", "riccati.cu", "ops/riccati_pallas.py:100",
             pallas["riccati_bwd_constq"]),
            ("riccati_bwd", "riccati.cu", "ops/riccati_pallas.py:56",
             per_stage_q["riccati_bwd"]),
            ("riccati_fwd", "riccati.cu", "ops/riccati_pallas.py:142",
             pallas["riccati_fwd"]),
            ("merit_alpha", "merit.cu", "models/merit_pallas.py:131",
             pallas["merit_alpha"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"srbd_nmpc_tpu_torch/csrc/{source}",
            "replaces": f"srbd_nmpc_tpu/{replaces}", "launches": n,
            "max_abs_err": k_err[name], "ms": k_t[name][0],
            "plain_ms": k_t[name][1]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
