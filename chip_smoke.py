"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``srbd_nmpc_tpu_torch/csrc`` (phase 2
prints the ptxas registers and spills of each launch of K1's gains, rank-6
and factor bodies, ``sqp_planes.cu``, of K3's trip, ``sqp_onepass.cu``, of
the two instantiations of K6's backward team kernel, ``riccati.cu``, and of
K4a's four launches, and says whether K1s-B's gains and factor forms and
K6's team kernel read as recorded), checks each against its plain PyTorch
version at the main path's shapes (phase 4: K1's gains, rank-6 and factor
bodies, each timed at the four widths the main path launches; then the
gains body's launches against the plain version at B=4096, 4093 and
131072, timed at the four widths with each launch's device ms; then the
same for the factor body's launches, timed in alternated rounds with the
gains body's, with the byte floor of both; then the rank-6 body's
launches, bitwise to plain at B=4096, 4093 and 131072, timed at B=131072
and 4096 with each launch's device ms, reported as they are; phase 3: the
lane permutes K2a/K2b bitwise on the engine's shapes and the edge cases,
timed per call and on the device beside ``index_select`` / ``index_copy``
at every compaction crossing of the cold solve), then drives the
port's main path (``parallel.sharded.solve_batch``, the default NmpcConfig:
N=20, speculative fused SQP trips, compaction tiers (2, 8, 32)) on a cold and
a warm B=131072 solve (phase 5 also profiles one cold solve: K1's share of
device time by launch), and checks the results: convergence, compaction
bitwise on the card, the kernel path against the plain path on the CPU, and
the independent f64 C++ oracle (``native/srbd_oracle.cpp``). Phases 10-12 do
the same for the iteration-synchronous loop: its kernels (K5, K6, K7a)
against their plain versions; phase 10b K6's backward team kernel (the
``pallas`` route's) against plain at B=4096, 4093 (a ragged edge) and
131072, timed at the four widths with its device ms; phase 10c K5's and
K7a's launches the same way (bitwise to plain at B=4096, 4093 and 131072;
timed at B=131072 and 4096); cold B=131072 solves on its ``pallas`` and
``fused`` routes against the speculative path (the ``pallas`` solve
profiled: K6a's device ms and share), and each kernel route against the
plain ``xla`` route. Phases 13-14 do it for the dense one-pass route
(``planes=False``): its kernels (K3a, K3b: timed at the four widths with
each launch's device ms) and the two-pass oracle (K4a, K4b) against their
plain versions (at B=4096 and at B=131072), K4a's four launches (K5's two,
a merit pass, K6a's team pass writing Acl and bcl) bitwise to plain at
B=4096, 4093 and 131072, timed with each launch's device ms beside K6a's
own team kernel on the same stage inputs, K3b against K4 on the inputs the
JAX tests' f32 tolerances were set on, and cold B=131072 solves of the
dense route on both loops. Phase 15 checks the batched merit with diagnostics
(K7b, with and without gradients) against its plain version at B=4096 and
B=131072 and drives it through ``engine._merit_fast``; phase 16 drives the
single-scenario solve (one robot, ``x [N+1, 12]``, the reference's own
workload: a batch of one on the plain ``xla`` route) on the card in f64
against the CPU and the f64 oracle, in f32 against the CPU and the oracle,
and with exact sensitivities, and times its cold and warm solves; phase 16b
runs the batched exact-sensitivity (``xla``) route at B=4096 against the
CPU; phase 17 runs the cold B=131072 problem with ``park_factor=True`` (K1's
factor body) on the speculative loop and the synchronous ``fused`` route,
and profiles one solve of each (the factor body's device time by launch).
Each path's launch counts are set to 0 just before it is driven and read
just after; K1's rank-6 body, which no engine route takes (as in JAX), is
driven by direct calls of the op in phase 4, and K4, which none takes
either, by a direct ``sqp_qp_solve`` call in phase 13.

The ``kernels`` line gives, for each of the 16 kernel bodies behind the 12
TPU call sites (K1's gains, rank-6 and factor rows, K3a's, K3b's, K4a's,
K5's and K7a's each with a row for each of its launches; K6a's and K6b's
on the team kernel), its launches on its
path, its largest difference from the plain version, ms per launch (kernel,
plain, and the one PyTorch call that computes the same function where there
is one) at the main path's shapes, timed over eager calls as the path makes
them (K2's entries add ``device_ms`` and ``library_device_ms``, the device
alone, from CUDA graphs), and its bound: the larger of the bytes it
must move over the HBM rate and its operations over the FP32 rate. The
operations are the kernel's own arithmetic on this run's inputs
(``utils.opcount``: its launches' bodies built as host C++ with a counting
scalar, run on 1,024 lanes spread over the batch, scaled to the width).

Every phase prints one line and raises on failure (non-zero exit). The line
before the last is the card's ``nvidia-smi`` name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card the script
exits non-zero before any result. Imports nothing of JAX.

    python3 chip_smoke.py --k2-only

runs phases 1-3 alone (only ``permute.cu`` is built) and reports the
device kernels per K2 call instead of requiring one. It imports the
``srbd_nmpc_tpu_torch`` beside the script, so a copy of the script in an
unpacked older commit times that commit's K2 on the same card.

    python3 chip_smoke.py --k1s-b-trees build/parent [build/other ...]

runs phases 1-2 for ``sqp_planes.cu`` alone and builds K1s-B
(``k1s_riccati_team_kernel`` and its float64 form) from each named tree's
source (an unpacked checkout, such as ``git archive <commit> | tar -x -C
build/parent``): each build's parks against this tree's at B=4093 and the
speculative loop's three widths (bitwise expected), and its ms per call
beside the first tree's, in alternated rounds in one process.
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
SOURCES = ("permute", "sqp_planes", "linearize", "riccati", "merit",
           "sqp_onepass", "sqp_twopass")
# the synchronous routes: converged within 0.5 % of B and mean SQP
# iterations within 0.1 of the speculative path's cold solve
SYNC_ROUTES = {"pallas": dict(qp_kernel="pallas"),
               "fused": dict(qp_kernel="fused", speculative=False)}
# the dense one-pass route on both loops
DENSE_ROUTES = {"spec": dict(planes=False),
                "sync": dict(planes=False, qp_kernel="fused", speculative=False)}
# K1's stage bodies by the port's counter names, and park_factor on the two
# loops that run K1
K1_BODIES = {"sqp_planes": {}, "sqp_planes_rank6": dict(rank6=True),
             "sqp_planes_factor": dict(factor=True)}
K1_WIDTHS = (B_MAIN, B_MAIN // 2, B_MAIN // 8, B_MAIN // 32)
# the gains body's launches by their device kernel names
K1S_PASSES = {"K1s-A": "k1s_planes_kernel",
              "K1s-B": "k1s_riccati_team_kernel",
              "K1s-C": "k1s_rollout_kernel"}
# the factor body's launches: the same plane pass, the factor forms of the
# Riccati pass and of the rollout
K1FS_PASSES = {"K1s-A": "k1s_planes_kernel",
               "K1s-B factor": "k1s_riccati_factor_kernel",
               "K1s-C factor": "k1s_rollout_factor_kernel"}
# the plane pass's ptxas reports (registers, spill stores), as PERF.md
# records them: the float32 form's, which the float64 form's split does not
# change, and the float64 form's (its two parts in one launch)
K1S_A_PTXAS = (168, 36)
K1S_A_F64_PTXAS = (128, 88)
# K1s-B's ptxas reports (registers, spill stores) by kernel, as PERF.md
# records them: the gains form's (with its block park; 6 blocks of 128
# threads an SM leave it 80 registers), the factor form's, and the float64
# form's (8 blocks of 64 threads: 128 registers)
K1S_B_PTXAS = {"k1s_riccati_team_kernel": (80, 24),
               "k1s_riccati_factor_kernel": (80, 0),
               "k1s_riccati_team_f64_kernel": (128, 0)}
# widths of K1s-B's comparison with other trees' builds (--k1s-b-trees): the
# three widths the speculative loop launches it at (its parks are also
# checked at 4093, a ragged edge)
K1S_B_TREE_WIDTHS = (B_MAIN, B_MAIN // 2, B_MAIN // 32)
# the factor body's kernels on the card, and the gains body's timed in the
# same rounds
K1F_BODIES = ("factor", "gains")
# widths of K1's checks against plain: a ragged edge (lanes not a multiple
# of a block's teams) beside B=4096 and B=131072
K1F_CHECK_WIDTHS = (4096, 4093, B_MAIN)
# the rank-6 body's launches: the gains body's plane pass and rollout, the
# rank-6 form of the Riccati pass
K1RS_PASSES = {"K1s-A": "k1s_planes_kernel",
               "K1s-B rank-6": "k1s_riccati_rank6_kernel",
               "K1s-C": "k1s_rollout_kernel"}
# the gains body's float64 form (a float64 batch on the speculative route)
# by its device kernel names
K1S_F64_PASSES = {"K1s-A f64": "k1s_planes_f64_kernel",
                  "K1s-B f64": "k1s_riccati_team_f64_kernel",
                  "K1s-C f64": "k1s_rollout_f64_kernel"}
# widths of the rank-6 and K4a sections' timed rounds (their checks against
# plain run at K1F_CHECK_WIDTHS)
DESIGN_WIDTHS = (B_MAIN, 4096)
# K4a's launches by their device kernel names
K4AS_PASSES = {"K5 stage": "k5s_stage_kernel", "K5 dense": "k5s_dense_kernel",
               "merit": "k4s_merit_kernel", "team": "riccati_team_acl_kernel"}
# K6's team kernel's ptxas report (registers, spill stores) by
# instantiation, as PERF.md records it: K4a's Acl form beside it does not
# change it
K6_TEAM_PTXAS = {"team <true>": (128, 0), "team <false>": (148, 0)}
# K3 (the dense route's one-pass trip) by its counter names
K3_NAMES = ("sqp_onepass_cand", "sqp_onepass")
# K3's launches by their device kernel names (K3s-B is K1s-B's kernel,
# launched through sqp_planes.cu)
K3S_PASSES = {"K3s-A": "k3s_planes_kernel",
              "K3s-B": "k1s_riccati_team_kernel",
              "K3s-C": "k3s_rollout_kernel"}
# K6's two instantiations by the port's counter names
K6_NAMES = ("riccati_bwd_constq", "riccati_bwd")
# widths of the K6 designs' checks against plain: a ragged edge (lanes not a
# multiple of a block's teams) beside the two of phase 13's checks
K6_CHECK_WIDTHS = (4096, 4093, B_MAIN)
# K5's and K7a's launches by their device kernel names
K5_PASSES = {"stage": "k5s_stage_kernel", "dense": "k5s_dense_kernel"}
K7A_PASSES = {"stage": "k7s_stage_kernel", "reduce": "k7s_reduce_kernel"}
# words per lane that the launches move beyond their inputs read once and
# their outputs written once, at N=20: K5's write and read the ddb hand-off
# [N, 24, B], and its dense write reads x (rows 0-8) and u (rows 0-2, 6-8)
# again for A and x (rows 6-8) for B; K7a's write and read its terms
# [3N + 1, B]
K5_EXTRA_WORDS = (2 * 24 + 18) * N_MAIN
K7A_EXTRA_WORDS = 2 * (3 * N_MAIN + 1)
# widths of phase 10c's checks against plain (a ragged edge: no multiple of
# a block's 128 lanes) and of its timed rounds
K5K7_CHECK_WIDTHS = (4096, 4093, B_MAIN)
K5K7_WIDTHS = (B_MAIN, 4096)
# seconds the profiler's window is held open on either side of a profiled
# call (_device_ms)
PROFILE_PAD_S = 3.0
# the default cold B=131072 solve as every run of the port has read it
# (PRs 1-7): converged, mean SQP iterations, speculative trips
COLD_REF = (128135, 11.4225, 17)
FACTOR_ROUTES = {"spec": dict(park_factor=True),
                 "sync": dict(SYNC_ROUTES["fused"], park_factor=True)}
SYNC_CONV_FRAC = 0.005
SYNC_ITER_TOL = 0.1
PARITY_FLIP_FRAC = 0.005
# the dense route's kernels against each other on the card (K3b vs K4):
# the f32 tolerances of tests/test_sqp_pallas.py::test_sqp_qp_solve_matches_xla
DENSE_TOL = {"dx": (1e-4, 2e-4), "du": (1e-4, 2e-3)}
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


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


def _rounds(calls, reps: int) -> dict:
    """ms per call of each of ``calls`` (design -> callable) on the same
    inputs, in four alternated rounds (forward, backward, forward, backward;
    ``reps`` calls each, ``_cuda_ms``), the mean of the four."""
    order = list(calls)
    ms = dict.fromkeys(order, 0.0)
    for d in (order + order[::-1]) * 2:
        ms[d] += _cuda_ms(calls[d], reps) / 4
    return ms


def _nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (nested tuples flattened)."""
    n = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_build(sources=SOURCES):
    from concurrent.futures import ThreadPoolExecutor

    from srbd_nmpc_tpu_torch.utils import build, opcount

    t0 = time.perf_counter()
    # one nvcc per source, all started together, beside the g++ builds of
    # the operation counters
    counted = [s for s in opcount.SOURCES if s in sources]
    with ThreadPoolExecutor(len(sources) + len(counted)) as pool:
        done = [pool.submit(build.build, s) for s in sources]
        done += [pool.submit(opcount.build_source, s) for s in counted]
        for f in done:
            f.result()
    spills = {}
    for name in sources:
        build.load_kernel(name)
        lines = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "spill" in ln or "registers" in ln]
        spills[name] = lines
    secs = time.perf_counter() - t0
    print(f"[2 build] {len(sources)} sources (and {len(counted)} "
          "operation counters) built in parallel and loaded in "
          f"{secs:.1f} s", flush=True)
    for name, lines in spills.items():
        for ln in lines:
            print(f"[2 build] {name}: {ln}", flush=True)
    k1 = _k1s_ptxas() if "sqp_planes" in sources else {}
    k3 = (_k3_ptxas(k1) if {"sqp_onepass", "sqp_planes"} <= set(sources)
          else {})
    k6 = _k6_ptxas() if "riccati" in sources else {}
    k57 = (_k5_k7a_ptxas() if {"linearize", "merit"} <= set(sources)
           else {})
    k4 = (_k4a_ptxas() if {"linearize", "sqp_twopass", "riccati"}
          <= set(sources) else {})
    for what, regs in (("K1 ptxas by launch", k1),
                       ("K3 ptxas by launch", k3),
                       ("K6 backward ptxas", k6),
                       ("K5 and K7a ptxas by launch", k57),
                       ("K4a ptxas by launch", k4)):
        if regs:
            print(f"[2 build] {what}: "
                  + "; ".join(f"{n} {r} registers, {st} B spill stores, "
                              f"{ld} B spill loads, {sk} B stack"
                              for n, (r, st, ld, sk) in regs.items()),
                  flush=True)
    return secs, k1, k3, k6, k57, k4


# K2's shapes on the cold speculative path: the compaction crossings
# B -> B/2 -> B/8 -> B/32 gather xa and dx [21,12,.], us and du [20,12,.]
# and x0s [12,.]; the way back scatters xa and us. (leading shape,
# launches per crossing)
K2_CROSSINGS = ((B_MAIN, B_MAIN // 2), (B_MAIN // 2, B_MAIN // 8),
                (B_MAIN // 8, B_MAIN // 32))
K2_GATHERS = (((N_MAIN + 1, 12), 2), ((N_MAIN, 12), 2), ((12,), 1))
K2_SCATTERS = (((N_MAIN + 1, 12), 1), ((N_MAIN, 12), 1))
L2_BYTES = 50e6
# float32 words a permute must carry bit for bit: -0, +-inf, NaNs with
# payloads (as int32)
SPECIAL_WORDS = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001,
                          0xFFBADBAD, 0x7F812345], np.uint32).view(np.int32)


def _graph_ms(fn, reps: int = 100, per_graph: int = 20) -> float:
    """Device milliseconds per call of ``fn()``: ``reps`` calls captured in
    CUDA graphs of ``per_graph`` and replayed, so no host time lies between
    the launches (CUDA events around the replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps // per_graph):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps // per_graph * per_graph)


def _k2_data(gen, shape, dev):
    """Normal float32 data from ``gen`` with SPECIAL_WORDS among it."""
    t = torch.randn(shape, generator=gen, device=dev)
    pos = torch.randint(0, t.numel(), (4 * len(SPECIAL_WORDS),),
                        generator=gen, device=dev)
    t.view(-1).view(torch.int32)[pos] = torch.as_tensor(
        np.resize(SPECIAL_WORDS, pos.numel()), device=dev)
    return t


def _same_bits(x, y) -> bool:
    return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                              y.view(torch.int32))


def _k2_turns(kernel, library):
    """(kernel, library) ms per call as the engine calls them (back-to-back
    eager calls, the yardstick of every kernel's ``ms``), and on the device
    alone (CUDA graphs); each the mean of two runs taken in turns: library,
    kernel, kernel, library."""
    lib1, ker1 = _cuda_ms(library, 100), _cuda_ms(kernel, 100)
    ker2, lib2 = _cuda_ms(kernel, 100), _cuda_ms(library, 100)
    call_ms = ((ker1 + ker2) / 2, (lib1 + lib2) / 2)
    lib1, ker1 = _graph_ms(library), _graph_ms(kernel)
    ker2, lib2 = _graph_ms(kernel), _graph_ms(library)
    return call_ms, ((ker1 + ker2) / 2, (lib1 + lib2) / 2)


def phase_permute(dev):
    """K2a/K2b bitwise against their plain versions (index_select /
    index_copy) on the engine's shapes and the edge cases, with int32 and
    int64 idx; their times at every shape the cold speculative path
    launches them on, beside the library call; device kernels per call
    (returned, for the caller to hold to one)."""
    from srbd_nmpc_tpu_torch.ops import permute

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    main = (N_MAIN + 1, 12)
    half = B_MAIN // 2
    cases = [(f"{list(main) + [B_MAIN]} -> {Bc} {kind}", main, B_MAIN,
              _sorted_idx(rng, B_MAIN, Bc, kind == "clumpy"))
             for Bc in (half, B_MAIN // 32) for kind in ("uniform", "clumpy")]
    cases += [(f"dense prefix {half}", main, B_MAIN, np.arange(half)),
              ("Bc = B", main, B_MAIN, np.arange(B_MAIN)),
              (f"x0s [12,{B_MAIN}] -> {half}", (12,), B_MAIN,
               _sorted_idx(rng, B_MAIN, half, False)),
              ("[7,500] -> 77", (7,), 500, _sorted_idx(rng, 500, 77, False)),
              ("[3,12,4099] -> 1031", (3, 12), 4099,
               _sorted_idx(rng, 4099, 1031, True))]
    data = {}
    for name, lead, B, idx_np in cases:
        if (lead, B) not in data:
            data[(lead, B)] = _k2_data(gen, lead + (B,), dev)
        a = data[(lead, B)]
        a_bits = a.clone()
        src = _k2_data(gen, lead + (len(idx_np),), dev)
        for dtype in (torch.int32, torch.int64):
            idx = torch.as_tensor(idx_np, dtype=dtype, device=dev)
            idx64 = idx.long()
            got = permute.take_lanes(a, idx)
            got_s = permute.set_lanes(a, src, idx)
            ok = (_same_bits(got, permute.take_lanes_ref(a, idx64))
                  and _same_bits(got_s, permute.set_lanes_ref(a, src, idx64))
                  and _same_bits(a, a_bits)
                  and torch.equal(idx.cpu().long(), torch.as_tensor(idx_np)))
            torch.cuda.synchronize()
            if not ok:
                raise AssertionError(f"K2 not bitwise on {name} ({dtype})")
        del a_bits, src
    del data
    print(f"[3 K2] take_lanes/set_lanes bitwise equal to plain (-0, inf, NaN "
          f"payloads included), inputs untouched, int32 and int64 idx, on: "
          + "; ".join(c[0] for c in cases), flush=True)

    # times at every shape of the cold speculative path; library calls are
    # index_select / index_copy with the engine's int64 idx
    times, per_solve = {}, np.zeros(4)   # kernel, library: call, device
    for B, Bc in K2_CROSSINGS:
        idx = torch.as_tensor(_sorted_idx(rng, B, Bc, False), device=dev)
        rows = [("take_lanes", lead, n, B, Bc) for lead, n in K2_GATHERS]
        rows += [("set_lanes", lead, n, B, Bc) for lead, n in K2_SCATTERS]
        for name, lead, n, B_, Bc_ in rows:
            a = torch.randn(lead + (B_,), generator=gen, device=dev)
            if name == "take_lanes":
                src = None
                out = permute.take_lanes_ref(a, idx)
                kern = lambda: permute.take_lanes(a, idx)      # noqa: E731
                lib = lambda: a.index_select(-1, idx)           # noqa: E731
                nbytes = 2 * _nbytes(out) + _nbytes(idx)
                operands = _nbytes(a, out, idx)
                label = f"gather {list(lead) + [B_]} -> {Bc_}"
            else:
                src = torch.randn(lead + (Bc_,), generator=gen, device=dev)
                kern = lambda: permute.set_lanes(a, src, idx)  # noqa: E731
                lib = lambda: a.index_copy(a.dim() - 1, idx, src)  # noqa: E731
                nbytes = 2 * _nbytes(a) + _nbytes(idx)
                operands = 2 * _nbytes(a) + _nbytes(src, idx)
                label = f"scatter {Bc_} -> {list(lead) + [B_]}"
            (k_call, l_call), (k_dev, l_dev) = _k2_turns(kern, lib)
            bound = _bound(nbytes, 0)
            times[(name, lead, B_, Bc_)] = (k_call, l_call, k_dev, l_dev,
                                            bound)
            per_solve += n * np.array([k_call, l_call, k_dev, l_dev])
            # slower than the library by more than 5 % or 2 us
            slower = [what for what, k, l in (("per call", k_call, l_call),
                                              ("on the device", k_dev, l_dev))
                      if k > l + max(0.05 * l, 2e-3)]
            print(f"[3 K2] {label} (operands {operands / 1e6:.1f} MB, "
                  f"{'within' if operands <= L2_BYTES else 'beyond'} the "
                  f"50 MB L2): kernel {k_call:.4f} ms per call, "
                  f"{k_dev:.4f} on the device; library {l_call:.4f} / "
                  f"{l_dev:.4f}; bound {bound[0]:.4f} ms, "
                  f"{100 * bound[0] / k_dev:.0f} % of it on the device"
                  + "".join(f"; SLOWER than the library {w}" for w in slower),
                  flush=True)
            del a, src
    torch.cuda.empty_cache()
    print(f"[3 K2] per cold speculative solve ({sum(n for _, n in K2_GATHERS)}"
          f" gathers and {sum(n for _, n in K2_SCATTERS)} scatters at each of "
          f"{len(K2_CROSSINGS)} crossings): per call kernels "
          f"{per_solve[0]:.4f} ms, library calls {per_solve[1]:.4f} ms; on "
          f"the device {per_solve[2]:.4f} / {per_solve[3]:.4f} ms",
          flush=True)

    # device kernels of one call at the reference shape
    a = torch.randn(main + (B_MAIN,), generator=gen, device=dev)
    idx = torch.as_tensor(_sorted_idx(rng, B_MAIN, B_MAIN // 2, False),
                          device=dev)
    src = permute.take_lanes_ref(a, idx)
    per_call = {
        "take_lanes": _device_ms(lambda: permute.take_lanes(a, idx))[1],
        "set_lanes": _device_ms(lambda: permute.set_lanes(a, src, idx))[1],
        "index_select": _device_ms(lambda: a.index_select(-1, idx))[1],
        "index_copy": _device_ms(lambda: a.index_copy(2, idx, src))[1]}
    print(f"[3 K2] device kernels per call (torch.profiler, int64 idx): "
          f"{per_call}", flush=True)
    del a, idx, src
    torch.cuda.empty_cache()
    # the kernels line: the reference shape [21,12,131072] -> 65536; ms per
    # call and the device times beside them; the plain versions are the
    # library calls themselves
    return {name: times[(name, main, B_MAIN, B_MAIN // 2)]
            for name in ("take_lanes", "set_lanes")}, per_call


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
    """K1's three stage bodies against their plain versions at N=20,
    B=4096 (alpha 0 and random alpha), and against the plain versions in
    f64 (printed); the rank-6 body's path (direct calls
    of the op, as in JAX no engine route takes it) with its counts; each
    body's ms per launch at the main path's widths (in turns, in this
    call), its plain ms and bound at full width."""
    from srbd_nmpc_tpu_torch.ops import sqp_planes
    from srbd_nmpc_tpu_torch.utils import opcount
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    rng = np.random.default_rng(0)
    cases = [_k1_inputs(rng, N_MAIN, 4096, dev, az) for az in (True, False)]
    # the rank-6 body's path: the benchmark weights are leg-block-diagonal,
    # so each call must run the 6x6 stage
    torch.cuda.synchronize()
    _reset_counts()
    r6_out = [sqp_planes.sqp_qp_solve_onepass_planes(*a, reg=reg, rank6=True)
              for a, reg in cases]
    torch.cuda.synchronize()
    r6_launches = {k: v for k, v in _counts().items() if v}
    print(f"[4 K1] rank-6 path ({len(cases)} direct calls, rank6=True, "
          f"B=4096): launches {r6_launches}", flush=True)
    if r6_launches != {"sqp_planes_rank6": len(cases)}:
        raise AssertionError(f"rank6=True launches {r6_launches}")

    worst, max_abs, vs64 = {}, {}, {}
    for name, flags in K1_BODIES.items():
        w = {"dx": 0.0, "du": 0.0, "dphi": 0.0, "theta": 0.0, "phi": 0.0}
        max_abs[name] = 0.0
        vs64[name] = {"dx": 0.0, "du": 0.0}
        for i, (args, reg) in enumerate(cases):
            got = (r6_out[i] if name == "sqp_planes_rank6" else
                   sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=reg,
                                                          **flags))
            ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg,
                                                             **flags)
            # the f32 kernel against the plain version in f64 on the same
            # (f32-rounded) inputs: how much each stage body loses to f32
            ref64 = sqp_planes.sqp_qp_solve_onepass_planes_ref(
                *_f64(args), reg=reg, **flags)
            for j, key in enumerate(("dx", "du")):
                vs64[name][key] = max(vs64[name][key], parity_metric(
                    got[j].cpu().numpy(), ref64[j].cpu().numpy()))
            del ref64
            torch.cuda.synchronize()
            for j, key in enumerate(("dx", "du", "dphi")):
                g, r = got[j].cpu().numpy(), ref[j].cpu().numpy()
                if not np.all(np.isfinite(g)):
                    raise AssertionError(f"{name} {key} not finite")
                w[key] = max(w[key], parity_metric(g, r))
                max_abs[name] = max(max_abs[name],
                                    float(np.max(np.abs(g - r))))
            for j, key in ((0, "theta"), (1, "phi")):
                g = got[3][j].cpu().numpy().astype(np.float64)
                r = ref[3][j].cpu().numpy().astype(np.float64)
                w[key] = max(w[key], float(np.max(np.abs(g - r)
                                                  / np.abs(r))))
        worst[name] = w
        print(f"[4 K1] {KERNEL_IDS[name]} kernel vs plain at N=20, B=4096, "
              "alpha=0 and random alpha: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in w.items())
              + f" (limit {REL_TOL:g}); max |diff| {max_abs[name]:.3e}; vs "
              "the plain version in f64 (printed, not held): " + ", ".join(
                  f"{k} {v:.3e}" for k, v in vs64[name].items()), flush=True)
    del cases, r6_out
    bad = {n: w for n, w in worst.items()
           if not all(v < REL_TOL for v in w.values())}
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")

    # times at the main path's widths: full width and the three tiers, the
    # bodies on the same inputs in turns (forward, then backward; the mean
    # of the two runs of 10 launches each)
    times = {name: {} for name in K1_BODIES}
    order = list(K1_BODIES)
    for B in K1_WIDTHS:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        for name in order + order[::-1]:
            ms = _cuda_ms(lambda: sqp_planes.sqp_qp_solve_onepass_planes(
                *args, reg=reg, **K1_BODIES[name]), 10)
            times[name][B] = times[name].get(B, 0.0) + ms / 2
        del args
    args, reg = _k1_inputs(rng, N_MAIN, B_MAIN, dev, False)
    plain_ms, bounds = {}, {}
    for name, flags in K1_BODIES.items():
        plain_ms[name] = _cuda_ms(
            lambda: sqp_planes.sqp_qp_solve_onepass_planes_ref(
                *args, reg=reg, **flags), 1)
        out = sqp_planes.sqp_qp_solve_onepass_planes(*args, reg=reg, **flags)
        bounds[name] = _bound(_nbytes(args[6:13], out),
                              opcount.count_sqp_planes(*args, reg=reg,
                                                       **flags))
        del out
        torch.cuda.empty_cache()
    del args
    gains = times["sqp_planes"]
    for name in K1_BODIES:
        print(f"[4 K1] {KERNEL_IDS[name]} ms per launch: " + ", ".join(
            f"B={B} {ms:.3f} ({ms / gains[B]:.3f}x gains)"
            for B, ms in times[name].items())
            + f"; plain at B={B_MAIN}: {plain_ms[name]:.3f} ms; bound "
            f"{bounds[name][0]:.3f} ms ({bounds[name][1]})", flush=True)
    return max_abs, times, plain_ms, bounds, r6_launches


def _k1_err(got, ref):
    """(worst relative error of dx, du, dphi, theta, phi by key; max |diff|
    over dx, du, dphi; whether all seven outputs are bitwise equal)."""
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    w, mx = {}, 0.0
    for j, key in enumerate(("dx", "du", "dphi")):
        g, r = got[j].cpu().numpy(), ref[j].cpu().numpy()
        if not np.all(np.isfinite(g)):
            raise AssertionError(f"K1 {key} not finite")
        w[key] = parity_metric(g, r)
        mx = max(mx, float(np.max(np.abs(g - r))))
    for j, key in ((0, "theta"), (1, "phi")):
        g = got[3][j].cpu().numpy().astype(np.float64)
        r = ref[3][j].cpu().numpy().astype(np.float64)
        w[key] = float(np.max(np.abs(g - r) / np.abs(r)))
    same = all(torch.equal(g, r) for g, r in zip((*got[:3], *got[3]),
                                                  (*ref[:3], *ref[3])))
    return w, mx, same


def phase_k1_designs(dev):
    """The gains body's three launches at N=20: against the plain version
    at K1F_CHECK_WIDTHS (alpha 0 and random alpha at B=4096, random alpha
    at the others), max |diff| printed, bitwise expected; ms per call at the
    main path's four widths (four rounds of 10 calls); each launch's device
    ms (torch.profiler) at each width."""
    from srbd_nmpc_tpu_torch.ops import sqp_planes

    rng = np.random.default_rng(1)
    err = ({}, 0.0, True)
    for B, az in [(4096, True)] + [(B, False) for B in K1F_CHECK_WIDTHS]:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, az)
        ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg)
        got = sqp_planes._gains_cuda(*args, reg=reg)
        torch.cuda.synchronize()
        w, mx, same = _k1_err(got, ref)
        print(f"[4 K1] gains vs plain at B={B}, alpha "
              f"{'0' if az else 'random'}: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in w.items())
              + f" (limit {REL_TOL:g}); max |diff| {mx:.3e}; bitwise "
              f"{same}", flush=True)
        err = ({k: max(v, err[0].get(k, 0.0)) for k, v in w.items()},
               max(mx, err[1]), same and err[2])
        del got, args, ref
        torch.cuda.empty_cache()
    if not all(v < REL_TOL for v in err[0].values()):
        raise AssertionError(f"the gains kernels disagree with plain: "
                             f"{err[0]}")

    # ms per call in four rounds (_rounds, 10 calls each); then each
    # launch's device ms
    times, passes = {}, {}
    for B in K1_WIDTHS:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        call = lambda: sqp_planes._gains_cuda(*args, reg=reg)  # noqa: E731
        times[B] = _rounds({"gains": call}, 10)["gains"]
        passes[B] = _launch_ms(call, K1S_PASSES)
        del args, call
        torch.cuda.empty_cache()
    print("[4 K1] gains ms per call: " + ", ".join(
        f"B={B} {ms:.3f}" for B, ms in times.items()), flush=True)
    for B, by in passes.items():
        print(f"[4 K1] gains device ms per launch at B={B}: "
              + ", ".join(f"{p} {v:.3f}" for p, v in by.items()), flush=True)
    return err, times, passes


def phase_k1_f64(dev):
    """K1's gains body and K2 in float64, the speculative route's kernels
    for a float64 batch: the float64 forms of the three split launches
    against the plain version in float64 at K1F_CHECK_WIDTHS (alpha 0 and
    random alpha at B=4096, random alpha at the others), bitwise expected
    on all seven outputs; their ms per call beside the float32 split in
    alternated rounds at the main path's widths and each float64 launch's
    device ms; then K2's 8-byte form against index_select / index_copy
    bitwise at the crossings' shapes, and its ms per call beside the
    4-byte form's."""
    from srbd_nmpc_tpu_torch.ops import permute, sqp_planes

    rng = np.random.default_rng(5)
    same_all = True
    for B, az in [(4096, True)] + [(B, False) for B in K1F_CHECK_WIDTHS]:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, az)
        a64 = _f64(args)
        ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*a64, reg=reg)
        got = sqp_planes.sqp_qp_solve_onepass_planes(*a64, reg=reg)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.float64
        w, mx, same = _k1_err(got, ref)
        same_all = same_all and same
        print(f"[4 K1 f64] gains split (float64) vs plain float64 at B={B}, "
              f"alpha {'0' if az else 'random'}: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in w.items())
              + f"; max |diff| {mx:.3e}; bitwise {same}", flush=True)
        del args, a64, ref, got
        torch.cuda.empty_cache()
    times = {"float32": {}, "float64": {}}
    for B in K1_WIDTHS:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        a64 = _f64(args)
        ms = _rounds({"float32": lambda: sqp_planes._gains_cuda(*args, reg=reg),
                      "float64": lambda: sqp_planes._gains_cuda(*a64, reg=reg)},
                     10)
        for k, v in ms.items():
            times[k][B] = v
        if B == B_MAIN:
            by = _launch_ms(lambda: sqp_planes._gains_cuda(*a64, reg=reg),
                            K1S_F64_PASSES)
            print(f"[4 K1 f64] device ms per launch at B={B}: " + ", ".join(
                f"{p} {v:.3f}" for p, v in by.items()), flush=True)
        del args, a64
        torch.cuda.empty_cache()
    print("[4 K1 f64] gains split ms per call: " + ", ".join(
        f"B={B} float32 {times['float32'][B]:.3f}, float64 "
        f"{times['float64'][B]:.3f} ({times['float64'][B] / times['float32'][B]:.2f}x)"
        for B in K1_WIDTHS), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    k2_same = True
    for (B, Bc) in K2_CROSSINGS:
        for lead, _ in K2_GATHERS:
            a32 = torch.randn(lead + (B,), generator=gen, device=dev)
            a64 = torch.randn(lead + (B,), generator=gen, device=dev,
                              dtype=torch.float64)
            a64.view(torch.int64).reshape(-1)[:3] = torch.tensor(
                [-2 ** 63, 0x7FF8000000000001, 0x7FF0123456789ABC],
                device=dev)
            src = torch.randn(lead + (Bc,), generator=gen, device=dev,
                              dtype=torch.float64)
            idx = torch.sort(torch.randperm(B, generator=gen, device=dev)[:Bc]
                             ).values
            take = permute.take_lanes(a64, idx)
            put = permute.set_lanes(a64, src, idx)
            same = (torch.equal(take.view(torch.int64),
                                permute.take_lanes_ref(a64, idx).view(torch.int64))
                    and torch.equal(put.view(torch.int64),
                                    permute.set_lanes_ref(a64, src, idx)
                                    .view(torch.int64)))
            k2_same = k2_same and same
            ms = _rounds({"take 4-byte": lambda: permute.take_lanes(a32, idx),
                          "take 8-byte": lambda: permute.take_lanes(a64, idx)},
                         20)
            print(f"[4 K2 f64] {lead + (B,)} -> {Bc}: 8-byte bitwise {same}; "
                  f"take ms per call 4-byte {ms['take 4-byte']:.4f}, 8-byte "
                  f"{ms['take 8-byte']:.4f}", flush=True)
    if not (same_all and k2_same):
        raise AssertionError(f"float64 K1 bitwise {same_all}, K2 {k2_same}")
    return times


# K1s-A f64's recorded ms a call at B=131072 as one thread a (stage, lane)
# (plane_stage in double, 255 registers, 892 B spill stores; PERF.md), for a
# run without the parent's tree
K1A_F64_PARENT_MS = {B_MAIN: 6.209}


def phase_k1a_f64(dev, parent=None):
    """K1s-A's float64 form alone (``srbd_k1s_planes_f64_launch``: every
    ``k1s_planes_f64*`` kernel) at K1_WIDTHS: ms a call in alternated rounds
    (``_rounds``), beside the same launch built from ``parent`` (an unpacked
    checkout of another commit, ``_tree_split``) on the same inputs, with
    the pack, the merit terms and the terminal stage held bitwise to the
    parent's at K1F_CHECK_WIDTHS and K1_WIDTHS; without ``parent``, beside
    its recorded ms (K1A_F64_PARENT_MS). Fails unless bitwise."""
    import ctypes
    import os

    from srbd_nmpc_tpu_torch.ops import sqp_planes
    from srbd_nmpc_tpu_torch.ops.sqp_stage import kernel_constants

    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {"this": sqp_planes._lib().srbd_k1s_planes_f64_launch}
    if parent:
        plib, log = _tree_split(parent, "k1a_parent")
        fns["parent"] = plib.srbd_k1s_planes_f64_launch
        fns["parent"].argtypes = [P] * 10 + [I, I, D, D, P]
        fns["parent"].restype = ctypes.c_int
        for mangled, regs, stores, loads, _ in _ptxas("sqp_planes",
                                                      "k1s_planes_f64", log):
            print(f"[4 K1s-A f64] parent {os.path.basename(parent)}: "
                  f"{mangled} {regs} registers, {stores} B spill stores, "
                  f"{loads} B spill loads", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(29)
    same_all, times = True, {}
    for B in sorted(set(K1F_CHECK_WIDTHS) | set(K1_WIDTHS)):
        args, _ = _k1_inputs(rng, N_MAIN, B, dev, False)
        a64 = _f64(args)
        kc = kernel_constants(*a64[:6], torch.float64).block
        ins = [t.data_ptr() for t in (kc, *a64[6:12])]
        outs = {tag: [torch.full(sh, float("nan"), dtype=torch.float64,
                                 device=dev)
                      for sh in ((N_MAIN, sqp_planes._C, B),
                                 (N_MAIN, sqp_planes._M_C, B),
                                 (sqp_planes._T_C, B))] for tag in fns}

        def call(tag, out=None):
            out = outs[tag] if out is None else out
            sqp_planes._check(f"K1s-A f64 ({tag})", fns[tag](
                *ins, *(t.data_ptr() for t in out), N_MAIN, B,
                float(a64[13]), float(a64[14]), stream))

        for tag in fns:
            call(tag)
        torch.cuda.synchronize()
        if parent:
            same = all(torch.equal(a.view(torch.int64), b.view(torch.int64))
                       for a, b in zip(outs["this"], outs["parent"]))
            finite = all(bool(torch.isfinite(t).all()) for t in outs["parent"])
            same_all = same_all and same and finite
            print(f"[4 K1s-A f64] B={B}: pack, merit terms and terminal "
                  f"stage bitwise the parent's {same} (all written "
                  f"{finite})", flush=True)
        if B in K1_WIDTHS:
            times[B] = _rounds({tag: (lambda tag=tag: call(tag)) for tag in fns},
                               10)
        del args, a64, outs
        torch.cuda.empty_cache()
    print("[4 K1s-A f64] ms a call: " + ", ".join(
        f"B={B} " + " / ".join(f"{tag} {v:.3f}" for tag, v in t.items())
        + (f" ({t['this'] / t['parent']:.3f}x)" if "parent" in t else
           f" (the parent {K1A_F64_PARENT_MS[B]:.3f}, recorded)"
           if B in K1A_F64_PARENT_MS else "")
        for B, t in times.items()), flush=True)
    if not same_all:
        raise AssertionError("K1s-A f64 differs from the parent's")
    return times


def _tree_split(tree: str, tag: str):
    """``tree``'s K1s source built by nvcc with the port's flags into the
    build directory's ``trees/<tag>``: the loaded library and nvcc's
    ``-Xptxas -v`` report. The source is ``csrc/sqp_planes.cu``, or in a
    tree that still holds it ``csrc/sqp_planes_split.cu`` (there
    ``sqp_planes.cu`` is the one-thread body)."""
    import ctypes
    import os

    from srbd_nmpc_tpu_torch.utils import build

    csrc = os.path.join(tree, "srbd_nmpc_tpu_torch", "csrc")
    src = os.path.join(csrc, "sqp_planes_split.cu")
    if not os.path.exists(src):
        src = os.path.join(csrc, "sqp_planes.cu")
    out = os.path.join(build.BUILD_DIR, "trees", tag)
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libsqp_planes.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(lib), proc.stdout + proc.stderr


def _tree_k1s_b(tree: str, tag: str):
    """K1s-B's launches from ``tree``'s K1s source (``_tree_split``) by
    dtype (``srbd_k1s_riccati_launch``; ``srbd_k1s_riccati_f64_launch``
    where the tree has the float64 form), and their kernels'
    registers and spill stores (ptxas)."""
    import ctypes

    lib, log = _tree_split(tree, tag)
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    for dtype, name, kernel, scalar in (
            (torch.float32, "srbd_k1s_riccati_launch", "k1s_riccati_team_kernel",
             ctypes.c_float),
            (torch.float64, "srbd_k1s_riccati_f64_launch",
             "k1s_riccati_team_f64_kernel", ctypes.c_double)):
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = [P] * 5 + [I, I, scalar, P]
        fn.restype = ctypes.c_int
        out[dtype] = (fn, _ptxas("sqp_planes", kernel, log)[0][1:3])
    return out


def phase_k1s_b_trees(dev, trees):
    """Phases 1-2 for sqp_planes.cu, and K1s-B as built from each of
    ``trees`` (unpacked checkouts of other commits, or variants) beside
    this tree's, on this tree's K1s-A pack of the same inputs, in float32
    (``k1s_riccati_team_kernel``) and then in float64
    (``k1s_riccati_team_f64_kernel``, against the trees that have it): each
    tree's parks K and kv against this tree's at K1S_B_TREE_WIDTHS and at
    B=4093 (bitwise expected), then ms per call in four alternated rounds
    at K1S_B_TREE_WIDTHS (``_rounds``, 10 back-to-back launches each, CUDA
    events), each beside the first tree's; each build's registers and spill
    stores. Fails if a tree's parks differ from this tree's."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from srbd_nmpc_tpu_torch.ops import sqp_planes
    from srbd_nmpc_tpu_torch.ops.sqp_stage import kernel_constants

    tags = [os.path.basename(os.path.normpath(t)) for t in trees]
    with ThreadPoolExecutor(len(trees)) as pool:
        pending = pool.map(_tree_k1s_b, trees, tags)
        phase_build(("sqp_planes",))
        lib = sqp_planes._lib()
        built = [{torch.float32: (lib.srbd_k1s_riccati_launch,
                                  _ptxas("sqp_planes", "k1s_riccati_team_kernel")
                                  [0][1:3]),
                  torch.float64: (lib.srbd_k1s_riccati_f64_launch,
                                  _ptxas("sqp_planes", "k1s_riccati_team_f64_kernel")
                                  [0][1:3])}] + list(pending)
    tags = ["this"] + tags
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dtype in (torch.float32, torch.float64):
        have = [(tag, b[dtype]) for tag, b in zip(tags, built) if dtype in b]
        dtags = [tag for tag, _ in have]
        if len(dtags) < 2:
            continue
        f64 = "_f64" if dtype == torch.float64 else ""
        name = f"k1s_riccati_team{f64}_kernel"
        for tag, (_, (regs, stores)) in have:
            print(f"[K1s-B trees] {tag}: {name} {regs} registers, {stores} B "
                  f"spill stores", flush=True)
        planes = getattr(lib, f"srbd_k1s_planes{f64}_launch")
        rng = np.random.default_rng(23)
        for B in (4093, *K1S_B_TREE_WIDTHS):
            args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
            kc = kernel_constants(*args[:6], dtype=dtype).block
            xa, us, xra, dxc, duc, alpha = (a.to(dtype) for a in args[6:12])
            pack = torch.empty(N_MAIN, sqp_planes._C, B, device=dev, dtype=dtype)
            mer = torch.empty(N_MAIN, sqp_planes._M_C, B, device=dev, dtype=dtype)
            term = torch.empty(sqp_planes._T_C, B, device=dev, dtype=dtype)
            sqp_planes._check("K1s-A", planes(
                kc.data_ptr(), xa.data_ptr(), us.data_ptr(), xra.data_ptr(),
                dxc.data_ptr(), duc.data_ptr(), alpha.data_ptr(), pack.data_ptr(),
                mer.data_ptr(), term.data_ptr(), N_MAIN, B, float(args[13]),
                float(args[14]), stream))
            shapes = sqp_planes.park_shapes("gains", N_MAIN, B)[:2]
            parks = {tag: [torch.empty(sh, device=dev, dtype=dtype)
                           for sh in shapes] for tag in dtags}

            def call(tag, fn):
                return lambda: sqp_planes._check(f"K1s-B ({tag})", fn(
                    kc.data_ptr(), pack.data_ptr(), term.data_ptr(),
                    *(p.data_ptr() for p in parks[tag]), N_MAIN, B, float(reg),
                    stream))

            calls = {tag: call(tag, fn) for tag, (fn, _) in have}
            for c in calls.values():
                c()
            torch.cuda.synchronize()
            same = {tag: all(torch.equal(a, b) for a, b in
                             zip(parks[tag], parks["this"])) for tag in dtags[1:]}
            print(f"[K1s-B trees] {name} B={B}: K and kv bitwise equal to this "
                  f"tree's: {same}", flush=True)
            if not all(same.values()):
                raise AssertionError(f"{name}'s parks differ at B={B}: {same}")
            if B in K1S_B_TREE_WIDTHS:
                ms = _rounds(calls, 10)
                print(f"[K1s-B trees] {name} B={B} ms per call: " + ", ".join(
                    f"{tag} {v:.3f} ({v / ms[dtags[1]]:.3f}x {dtags[1]})"
                    for tag, v in ms.items()), flush=True)
            del args, pack, mer, term, parks, calls
            torch.cuda.empty_cache()


def _k1_split_bytes(N, B, factor):
    """Bytes the split K1 must move per call in float32, each array read
    once and written once by each launch that touches it: K1s-A reads the
    inputs (xa, xr, dxc [N+1,12,B]; us, duc [N,12,B]; alpha) and writes the
    pack [N,87,B], the merit terms [N,26,B] and the terminal rows [13,B];
    K1s-B reads the pack and qN and writes its parks (the gains K, kv: 156
    words a stage; the factor form's Yh, yv, L, dinv: 246); K1s-C reads 63
    of the pack's channels, the merit terms, the terminal rows, the parks
    and dx0, and writes dx[1:], du [N,24,B] and the five scalars [5,B]."""
    park = 246 if factor else 156
    inputs = 12 * (N + 1) * 3 + 12 * N * 2 + 1
    words = (inputs + (87 + 26) * N + 13                # K1s-A
             + 87 * N + 12 + park * N                   # K1s-B
             + (63 + 26 + park + 24) * N + 13 + 12 + 5)  # K1s-C
    return 4 * B * words


def _k1_body_call(body, args, reg):
    """One call of K1's ``body`` ("factor" or "gains") on ``_k1_inputs``'
    arguments."""
    from srbd_nmpc_tpu_torch.ops import sqp_planes

    fn = sqp_planes._factor_cuda if body == "factor" else sqp_planes._gains_cuda
    return lambda: fn(*args, reg=reg)


def phase_k1_factor_designs(dev):
    """The factor body's three launches (the park_factor path's) at N=20:
    against the plain factor body at K1F_CHECK_WIDTHS (alpha 0 and random
    alpha at B=4096, random alpha at the others), max |diff| printed,
    bitwise expected; ms per call at the main path's four widths in
    alternated rounds with the gains body's launches; each launch's device
    ms (torch.profiler), factor and gains, at each width; the byte floor of
    both."""
    from srbd_nmpc_tpu_torch.ops import sqp_planes

    rng = np.random.default_rng(17)
    err = ({}, 0.0, True)
    for B, az in [(4096, True)] + [(B, False) for B in K1F_CHECK_WIDTHS]:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, az)
        ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg,
                                                         factor=True)
        got = _k1_body_call("factor", args, reg)()
        torch.cuda.synchronize()
        w, mx, same = _k1_err(got, ref)
        print(f"[4 K1 factor] factor vs plain at B={B}, alpha "
              f"{'0' if az else 'random'}: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in w.items())
              + f" (limit {REL_TOL:g}); max |diff| {mx:.3e}; bitwise "
              f"{same}", flush=True)
        err = ({k: max(v, err[0].get(k, 0.0)) for k, v in w.items()},
               max(mx, err[1]), same and err[2])
        del got, args, ref
        torch.cuda.empty_cache()
    if not all(v < REL_TOL for v in err[0].values()):
        raise AssertionError(f"the factor kernels disagree with plain: "
                             f"{err[0]}")

    # ms per call in four alternated rounds (_rounds, 10 calls each); then
    # each launch's device ms
    times = {body: {} for body in K1F_BODIES}
    passes = {body: {} for body in K1F_BODIES}
    for B in K1_WIDTHS:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        ms = _rounds({body: _k1_body_call(body, args, reg)
                      for body in K1F_BODIES}, 10)
        for body in K1F_BODIES:
            times[body][B] = ms[body]
        for body, by_pass in (("factor", K1FS_PASSES), ("gains", K1S_PASSES)):
            passes[body][B] = _launch_ms(_k1_body_call(body, args, reg),
                                         by_pass)
        del args
        torch.cuda.empty_cache()
    gains = times["gains"]
    for body in K1F_BODIES:
        print(f"[4 K1 factor] {body} ms per call: " + ", ".join(
            f"B={B} {ms:.3f} ({ms / gains[B]:.3f}x gains)"
            for B, ms in times[body].items()), flush=True)
    for body, by_B in passes.items():
        for B, by in by_B.items():
            print(f"[4 K1 factor] {body} device ms per launch at B={B}: "
                  + ", ".join(f"{p} {v:.3f}" for p, v in by.items()),
                  flush=True)
    floor = {body: _k1_split_bytes(N_MAIN, B_MAIN, body == "factor")
             for body in K1F_BODIES}
    print(f"[4 K1 factor] bytes each body's launches move per call at "
          f"B={B_MAIN}: " + ", ".join(
              f"{body} {b / 1e9:.3f} GB, a floor of "
              f"{b / PEAK_BYTES * 1e3:.3f} ms at {PEAK_BYTES / 1e12:g} TB/s"
              for body, b in floor.items()), flush=True)
    return err, times, passes, floor


def phase_k1_rank6_designs(dev):
    """The rank-6 body's three launches at N=20: against the plain rank-6
    body at K1F_CHECK_WIDTHS (alpha 0 and random alpha at B=4096, random
    alpha at the others), max |diff| and a bitwise flag printed; ms per call
    in four rounds at DESIGN_WIDTHS; each launch's device ms (one profile a
    width); the launches' byte floor. Fails unless they are bitwise equal to
    plain on all seven outputs at every width. The times are reported as
    they are."""
    from srbd_nmpc_tpu_torch.ops import sqp_planes

    rng = np.random.default_rng(19)
    err = ({}, 0.0, True)
    for B, az in [(4096, True)] + [(B, False) for B in K1F_CHECK_WIDTHS]:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, az)
        ref = sqp_planes.sqp_qp_solve_onepass_planes_ref(*args, reg=reg,
                                                         rank6=True)
        got = sqp_planes._rank6_cuda(*args, reg=reg)
        torch.cuda.synchronize()
        w, mx, same = _k1_err(got, ref)
        print(f"[4 K1 rank-6] rank-6 vs plain at B={B}, alpha "
              f"{'0' if az else 'random'}: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in w.items())
              + f" (limit {REL_TOL:g}); max |diff| {mx:.3e}; bitwise "
              f"{same}", flush=True)
        err = ({k: max(v, err[0].get(k, 0.0)) for k, v in w.items()},
               max(mx, err[1]), same and err[2])
        del got, args, ref
        torch.cuda.empty_cache()
    if not all(v < REL_TOL for v in err[0].values()) or not err[2]:
        raise AssertionError(f"the rank-6 kernels disagree with plain or are "
                             f"not bitwise equal to it: {err}")

    times, passes = {}, {}
    for B in DESIGN_WIDTHS:
        args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
        call = lambda: sqp_planes._rank6_cuda(*args, reg=reg)  # noqa: E731
        times[B] = _rounds({"rank6": call}, 10)["rank6"]
        passes[B] = _launch_ms(call, K1RS_PASSES)
        del call, args
        torch.cuda.empty_cache()
    print("[4 K1 rank-6] ms per call: " + ", ".join(
        f"B={B} {ms:.3f}" for B, ms in times.items()), flush=True)
    for B, by in passes.items():
        print(f"[4 K1 rank-6] device ms per launch at B={B}: "
              + ", ".join(f"{p} {v:.3f}" for p, v in by.items()), flush=True)
    floor = _k1_split_bytes(N_MAIN, B_MAIN, False)
    print(f"[4 K1 rank-6] bytes the launches move per call at B={B_MAIN}: "
          f"{floor / 1e9:.3f} GB, a floor of {floor / PEAK_BYTES * 1e3:.3f} "
          f"ms at {PEAK_BYTES / 1e12:g} TB/s", flush=True)
    return err, times, passes, floor


def _f64(args):
    """K1's arguments with every tensor (the model parameters included) in
    float64."""
    import dataclasses

    params = args[0]
    p64 = dataclasses.replace(params, **{
        f.name: getattr(params, f.name).double()
        for f in dataclasses.fields(params)})
    return (p64,) + tuple(a.double() if isinstance(a, torch.Tensor) else a
                          for a in args[1:])


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
    for d in (sqp_planes.launches, permute.launches):
        for k in d:
            d[k] = 0
    st, info, summ = sharded.solve_batch(*prob)
    torch.cuda.synchronize()
    launches = {"sqp_planes": sqp_planes.launches["gains"], **permute.launches}

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
    if (abs(n_conv - COLD_REF[0]) > SYNC_CONV_FRAC * B_MAIN
            or abs(mean_it - COLD_REF[1]) > SYNC_ITER_TOL
            or trips != COLD_REF[2] or launches["sqp_planes"] != trips):
        raise AssertionError(f"cold solve {n_conv} at {mean_it:.4f} in {trips} "
                             f"trips, {launches['sqp_planes']} K1 calls: "
                             f"expected {COLD_REF}, one K1 call a trip")
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

    # where the time goes: one more cold solve under the profiler, K1's
    # device time by launch
    n_by = {}
    by_name, n = _device_ms(lambda: sharded.solve_batch(*prob), n_by)
    busy = sum(by_name.values())
    k1 = {p: (sum(v for k, v in by_name.items() if key in k),
              sum(c for k, c in n_by.items() if key in k))
          for p, key in K1S_PASSES.items()}
    k1_ms = sum(v for v, _ in k1.values())
    k1_n = sum(c for _, c in k1.values())
    rest = sorted(((k, v) for k, v in by_name.items() if "k1s_" not in k),
                  key=lambda kv: -kv[1])[:3]
    print(f"[5 cold] profiled cold solve: {n} device kernels, device busy "
          f"{busy:.3f} ms ({100 * busy / p50:.1f} % of the p50, so idle "
          f"{100 * (1 - busy / p50):.1f} %); K1 {k1_ms:.3f} ms in {k1_n} "
          f"device kernels ({100 * k1_ms / busy:.1f} % of device time): "
          + ", ".join(f"{p} {v:.3f} ms in {c} ({100 * v / busy:.1f} %)"
                      for p, (v, c) in k1.items() if c)
          + "; next kernels " + ", ".join(f"{k[:40]} {v:.3f}"
                                          for k, v in rest), flush=True)
    want = {p: launches["sqp_planes"] for p in k1}
    if {p: c for p, (_, c) in k1.items()} != want:
        raise AssertionError(f"K1 device kernels {k1}, expected {want}")
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
    from srbd_nmpc_tpu_torch.ops import (permute, riccati_kernel, sqp_kernel,
                                         sqp_planes)

    srbd_linearize.launches = 0
    for d in (sqp_planes.launches, permute.launches, riccati_kernel.launches,
              sqp_kernel.launches, merit_kernel.launches):
        for k in d:
            d[k] = 0


def _counts():
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize
    from srbd_nmpc_tpu_torch.ops import (permute, riccati_kernel, sqp_kernel,
                                         sqp_planes)

    k1 = sqp_planes.launches
    return {"sqp_planes": k1["gains"], "sqp_planes_rank6": k1["rank6"],
            "sqp_planes_factor": k1["factor"], **permute.launches,
            "linearize": srbd_linearize.launches, **riccati_kernel.launches,
            **merit_kernel.launches, **sqp_kernel.launches}


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
    from srbd_nmpc_tpu_torch.utils import opcount
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

    # bounds: each kernel's inputs and outputs at B=131072 and its own
    # operations on them
    ops = {
        "linearize": opcount.count_linearize(*lin_args),
        "riccati_bwd_constq": opcount.count_riccati_bwd(
            *bwd, Qc, L["R"], L["q"], L["r"], L["reg"]),
        "riccati_bwd": opcount.count_riccati_bwd(*bwd, Qs, L["R"], L["q"],
                                                 L["r"], L["reg"]),
        "riccati_fwd": opcount.count_riccati_fwd(*bwd, K, k, L["x0"]),
        "merit_alpha": opcount.count_merit_alpha(*merit_args),
    }
    ins = {"linearize": lin_args[5:9],
           "riccati_bwd_constq": (*bwd, L["R"], L["q"], L["r"]),
           "riccati_bwd": (*bwd, Qs, L["R"], L["q"], L["r"]),
           "riccati_fwd": (*bwd, K, k, L["x0"]),
           "merit_alpha": merit_args[6:12]}
    # K6a/K6b read only R's lower triangle: 78 of its 144 planes a stage
    r_upper = _nbytes(L["R"]) * (144 - 78) // 144
    less = {"riccati_bwd_constq": r_upper, "riccati_bwd": r_upper}
    bounds = {}
    for name, (kern, _) in calls.items():
        bounds[name] = _bound(_nbytes(ins[name], kern()) - less.get(name, 0),
                              ops[name])
    del calls, lin_args, L, K, k, merit_args, ins
    torch.cuda.empty_cache()
    print(f"[10 kernels] ms per launch at B={B_MAIN}, kernel (plain; bound): "
          + ", ".join(f"{k} {t[0]:.3f} ({t[1]:.3f}; {bounds[k][0]:.3f} "
                      f"{bounds[k][1]})" for k, t in times.items()),
          flush=True)
    return rel, max_abs, times, bounds


def _k6_args(L, name, B):
    """K6a's (``name`` "riccati_bwd_constq") or K6b's backward arguments
    (A, B, b, Q, R, q, r) on the first ``B`` lanes of the LQR data ``L``."""
    def cut(t):
        return t if B == t.shape[-1] else t[..., :B].contiguous()

    Q = L["Qc"] if name == "riccati_bwd_constq" else cut(L["Qs"])
    return (*(cut(L[k]) for k in ("A", "B", "b")), Q,
            *(cut(L[k]) for k in ("R", "q", "r")))


def phase_k6_designs(dev):
    """K6a and K6b's backward pass by the team kernel (the pallas route's)
    at N=20 on the benchmark problem's LQR data: against the plain version
    at K6_CHECK_WIDTHS, max |diff| printed, bitwise expected; ms per call at
    the main path's four widths (four rounds of 5 calls); its device ms
    (CUDA graphs) at each width."""
    from srbd_nmpc_tpu_torch.ops import riccati_kernel as rk
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    _, L, _, _ = _sync_kernel_inputs(np.random.default_rng(16), B_MAIN, dev)
    reg = L["reg"]
    err = {n: (0.0, 0.0, True) for n in K6_NAMES}
    for B in K6_CHECK_WIDTHS:
        for name in K6_NAMES:
            args = _k6_args(L, name, B)
            ref = rk.lqr_backward_ref(*args, reg)
            got = rk._lqr_backward_cuda(*args, reg)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{name}: not finite")
            rel = max(parity_metric(g.cpu().numpy().astype(np.float64),
                                    r.cpu().numpy().astype(np.float64))
                      for g, r in zip(got, ref))
            mx = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            print(f"[10b K6 team] {KERNEL_IDS[name]} vs plain at B={B}: "
                  f"{rel:.3e} (limit {REL_TOL:g}); max |diff| {mx:.3e}; "
                  f"bitwise {same}", flush=True)
            r0, m0, s0 = err[name]
            err[name] = (max(rel, r0), max(mx, m0), same and s0)
            del got, args, ref
    bad = {k: v for k, v in err.items() if not v[0] < REL_TOL}
    if bad:
        raise AssertionError(f"the K6 team kernel disagrees with plain: {bad}")

    # ms per call in four rounds (_rounds, 5 calls each); then its device
    # ms (CUDA graphs of 5 calls: the call launches the team kernel alone)
    times = {n: {} for n in K6_NAMES}
    dev_ms = {n: {} for n in K6_NAMES}
    for B in K1_WIDTHS:
        for name in K6_NAMES:
            args = _k6_args(L, name, B)
            call = lambda: rk._lqr_backward_cuda(*args, reg)  # noqa: E731
            times[name][B] = _rounds({"team": call}, 5)["team"]
            dev_ms[name][B] = _graph_ms(call, reps=10, per_graph=5)
            del args, call
    del L
    torch.cuda.empty_cache()
    for name in K6_NAMES:
        print(f"[10b K6 team] {KERNEL_IDS[name]} ms per call: " + ", ".join(
            f"B={B} {ms:.3f}" for B, ms in times[name].items())
            + "; device ms per launch: " + ", ".join(
                f"B={B} {v:.3f}" for B, v in dev_ms[name].items()),
            flush=True)
    return err, times, dev_ms


def _cut_lanes(args, lo, hi, B):
    """``args`` with the tensors at positions lo .. hi - 1 cut to their
    first ``B`` lanes."""
    return tuple(a[..., :B].contiguous() if lo <= i < hi and
                 B != a.shape[-1] else a for i, a in enumerate(args))


def _k5_k7a_call(kid, args):
    """One call of K5's or K7a's launches on its arguments, with the
    constants block built beforehand, as the engine builds it once per
    solve."""
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize

    if kid == "K5":
        kc = srbd_linearize.kernel_constants(*args[:5]).to(args[5].device)
        return lambda: srbd_linearize._linearize_cuda(*args, consts=kc)
    kc = merit_kernel.kernel_constants(*args[:6]).to(args[6].device)
    return lambda: merit_kernel._merit_alpha_cuda(*args, consts=kc)


def _k5_k7a_inputs(dev):
    """Phase 10c's kernels by id: (launches, the plain version, the
    arguments at a width, extra words), on phase 10's inputs."""
    from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize

    lin_full, _, _, merit_full = _sync_kernel_inputs(
        np.random.default_rng(18), B_MAIN, dev)
    return {
        "K5": (K5_PASSES, srbd_linearize.linearize_ref,
               lambda B: _cut_lanes(lin_full, 5, 9, B), K5_EXTRA_WORDS),
        "K7a": (K7A_PASSES, merit_kernel.merit_alpha_ref,
                lambda B: _cut_lanes(merit_full, 6, 12, B), K7A_EXTRA_WORDS)}


def phase_k5_k7a_designs(dev):
    """K5's and K7a's launches at N=20 on phase 10's inputs: each against
    the plain version at K5K7_CHECK_WIDTHS, bitwise flag and max |diff|
    printed; ms per call in four rounds at K5K7_WIDTHS; each launch's
    device ms (torch.profiler over 5 calls of each, one profile a width);
    the byte floor of each. Fails if either is not bitwise equal to plain
    at any width."""
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    kernels = _k5_k7a_inputs(dev)
    err = {k: (0.0, 0.0, True) for k in kernels}
    for B in K5K7_CHECK_WIDTHS:
        for kid, (_, plain, args_at, _) in kernels.items():
            args = args_at(B)
            ref = plain(*args)
            got = _k5_k7a_call(kid, args)()
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{kid}: not finite")
            rel = max(parity_metric(g.cpu().numpy().astype(np.float64),
                                    r.cpu().numpy().astype(np.float64))
                      for g, r in zip(got, ref))
            mx = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            print(f"[10c K5/K7a] {kid} vs plain at B={B}: {rel:.3e} (limit "
                  f"{REL_TOL:g}); max |diff| {mx:.3e}; bitwise {same}",
                  flush=True)
            r0, m0, s0 = err[kid]
            err[kid] = (max(rel, r0), max(mx, m0), same and s0)
            del got, args, ref
            torch.cuda.empty_cache()
    bad = {k: v for k, v in err.items() if not (v[0] < REL_TOL and v[2])}
    if bad:
        raise AssertionError(f"K5/K7a is not bitwise equal to plain "
                             f"(rel, max |diff|, bitwise): {bad}")

    # ms per call in four rounds (_rounds, 5 calls each); then each
    # launch's device ms
    times = {k: {} for k in kernels}
    dev_ms = {k: {} for k in kernels}
    floor = {}
    for B in K5K7_WIDTHS:
        calls = {}
        for kid, (_, _, args_at, extra) in kernels.items():
            args = args_at(B)
            calls[kid] = _k5_k7a_call(kid, args)
            if B == B_MAIN:
                # each input read once, each output written once, and the
                # launches' extra words per lane
                lo, hi = (5, 9) if kid == "K5" else (6, 12)
                floor[kid] = _nbytes(args[lo:hi], calls[kid]()) + 4 * B * extra
            del args
        for kid, ms in _rounds(calls, 5).items():
            times[kid][B] = ms
        # one profile of both kernels' launches (their kernels' names differ)
        tagged = {(kid, p): key for kid, v in kernels.items()
                  for p, key in v[0].items()}
        got = _launch_ms(lambda: [c() for c in calls.values()],
                         {"/".join(t): key for t, key in tagged.items()})
        for (kid, p) in tagged:
            dev_ms[kid].setdefault(B, {})[p] = got[f"{kid}/{p}"]
        del calls
        torch.cuda.empty_cache()
    for kid in kernels:
        print(f"[10c K5/K7a] {kid} ms per call: " + ", ".join(
            f"B={B} {ms:.3f}" for B, ms in times[kid].items())
            + "; device ms per launch: " + "; ".join(
                f"B={B} " + ", ".join(f"{p} {v:.3f}" for p, v in by.items())
                for B, by in dev_ms[kid].items())
            + f"; bytes per call at B={B_MAIN}: {floor[kid] / 1e9:.3f} GB, a "
            f"floor of {floor[kid] / PEAK_BYTES * 1e3:.3f} ms", flush=True)
    return err, times, dev_ms, floor


def _route_problem(dev, B, kw, seed=0):
    import dataclasses

    params, weights, cfg, states, x0s, x_ref = _cold_problem(B, dev, seed=seed)
    return params, weights, dataclasses.replace(cfg, **kw), states, x0s, x_ref


def phase_sync(dev, card, spec):
    """Cold B=131072 solves of the iteration-synchronous loop on its kernel
    routes (``pallas``, ``fused``, and the dense ``fused`` with
    ``planes=False``), each read against the speculative path's cold solve,
    each profiled (K5's, K7a's and on ``pallas`` K6a's device ms and
    share)."""
    from srbd_nmpc_tpu_torch.parallel import sharded

    n_spec, it_spec = spec
    need = {"pallas": ("linearize", "riccati_bwd_constq", "riccati_fwd",
                       "merit_alpha"),
            "fused": ("sqp_planes", "merit_alpha"),
            "dense": ("sqp_onepass", "merit_alpha")}
    out = {}
    for route, kw in {**SYNC_ROUTES, "dense": DENSE_ROUTES["sync"]}.items():
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
        print(f"[11 sync] {route} ({kw}) B={B_MAIN}: converged "
              f"{n_conv}/{B_MAIN} ({d_conv:+d} vs speculative), mean SQP "
              f"iterations {mean_it:.4f} ({d_it:+.4f}), SQP loops {loops}, "
              f"line-search trips {ls}, host syncs {syncs}, launches "
              f"{launches}; p50 {p50:.3f} ms per solve, "
              f"{B_MAIN / p50 * 1e3:.1f} solves/s (times "
              f"{[round(t, 3) for t in times]}) on {card}", flush=True)
        # where the time goes: one more solve under the profiler
        by_name, _ = _device_ms(lambda: sharded.solve_batch(*prob))
        busy = sum(by_name.values())

        def dev_of(keys):
            return sum(v for k, v in by_name.items()
                       if any(key in k for key in keys))

        shares = {"K5": dev_of(K5_PASSES.values()),
                  "K7a": dev_of(K7A_PASSES.values()),
                  # K6a's team kernel (K1s-B, k1s_riccati_team_kernel,
                  # runs on the other routes)
                  "K6a": (dev_of(("riccati_team_kernel",))
                          if route == "pallas" else 0.0)}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"[11 sync] {route} profiled solve: device busy {busy:.3f} ms "
              f"({100 * busy / p50:.1f} % of the p50, so idle "
              f"{100 * (1 - busy / p50):.1f} %), " + ", ".join(
                  f"{k} {v:.3f} ms ({100 * v / busy:.1f} % of device time)"
                  for k, v in shares.items() if v)
              + "; top kernels "
              + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top), flush=True)
        want = ("K5", "K7a", "K6a") if route == "pallas" else ("K7a",)
        if not all(shares[k] > 0.0 for k in want):
            raise AssertionError(f"{route}: profiled device ms {shares}")
        missing = [k for k in need[route] if not launches.get(k)]
        if missing:
            raise AssertionError(f"{route}: kernels never launched: {missing}")
        if not u_ok:
            raise AssertionError(f"{route}: a converged solution is not finite")
        if abs(d_conv) > SYNC_CONV_FRAC * B_MAIN or abs(d_it) > SYNC_ITER_TOL:
            raise AssertionError(f"{route}: converged {d_conv:+d}, mean "
                                 f"iterations {d_it:+.4f} vs speculative")
        out[route] = dict(launches=launches, n_conv=n_conv, mean_it=mean_it,
                          ls=ls, syncs=syncs, p50=p50, busy=busy,
                          shares=shares)
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
              "pallas": SYNC_ROUTES["pallas"],
              "fused+spec+dense": DENSE_ROUTES["spec"],
              "fused+dense": DENSE_ROUTES["sync"],
              "fused+spec+factor": FACTOR_ROUTES["spec"]}
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


def _k3_args(rng, B, dev):
    """K3a, K3b and K4a arguments on K1's random inputs (phase 4): the
    candidate call, the call at the iterate (dx0 = x0 - xa[0]) and K4a's."""
    args, reg = _k1_inputs(rng, N_MAIN, B, dev, False)
    head, (xa, us, xra, dxc, duc, alpha, x0s), tail = \
        args[:6], args[6:13], args[13:]
    return (head + (xa, us, xra, dxc, duc, alpha, x0s) + tail,
            head + (xa, us, xra, x0s - xa[0]) + tail,
            head + (xa, us, xra) + tail, reg)


def _flat(t):
    if isinstance(t, (tuple, list)):
        return [x for e in t for x in _flat(e)]
    return [t]


def _diff(got, ref):
    """(parity_metric, max |diff|) over every output tensor of two results,
    computed on their device in f64; raises if the first is not finite."""
    rel = max_abs = 0.0
    for g, r in zip(_flat(got), _flat(ref)):
        g, r = g.double(), r.double()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("kernel output not finite")
        d = (g - r).abs()
        mag = r.abs()
        scale = torch.clamp(mag, min=float(0.01 * mag.max()) + 1e-30)
        rel = max(rel, float((d / scale).max()))
        max_abs = max(max_abs, float(d.max()))
        del g, r, d, mag, scale
    return rel, max_abs


def _oracle_gap(one, two):
    """Worst |K3b - K4| / (atol + rtol |K4|) of dx and du, at DENSE_TOL."""
    gap = {}
    for i, key in ((0, "dx"), (1, "du")):
        rtol, atol = DENSE_TOL[key]
        g, r = one[i].double(), two[i].double()
        gap[key] = float(((g - r).abs() / (atol + rtol * r.abs())).max())
    return gap


def _setup_inputs(dev):
    """The inputs of tests/test_sqp_pallas.py::_setup (seed 0) and its
    test_sqp_qp_solve_matches_xla (B=128, N=12, x0 + 0.02 N(0,1)), on which
    that test's f32 tolerances were set: K3b's and K4's arguments."""
    from srbd_nmpc_tpu_torch.models import srbd
    from srbd_nmpc_tpu_torch.nmpc import engine

    B, N = 128, 12
    cfg = engine.NmpcConfig(N=N)
    params = srbd.SRBDParams.create(dt=0.015, device=dev)
    weights = engine.NmpcWeights.create(
        [0] * 11 + [10], 1e-4,
        [.5, .5, .5, .01, .01, .01, 100, 100, 100, 0, 0, 100], N, device=dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    rng = np.random.default_rng(0)

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    xa = T(np.transpose(rng.normal(size=(B, N + 1, 12)) * 0.3, (1, 2, 0)))
    us = T(np.transpose(rng.normal(size=(B, N, 12)) * 30 + 80, (1, 2, 0)))
    x0s = T(x0.cpu().numpy()[None] + 0.02 * rng.normal(size=(B, 12))).T
    xra = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    Ac, bc = srbd.constraint_matrix(params)
    return ((params, weights.Q, weights.Qf, weights.R, Ac, bc, xa, us, xra,
             (x0s - xa[0]).contiguous(), cfg.mu_barrier, cfg.theta_barrier),
            cfg.reg)


def phase_dense_kernels(dev):
    """K3a, K3b, K4a and K4b against their plain versions at N=20, B=4096
    and at B=131072 (the main path's full width); K3b against K4 (both
    kernels) at the f32 tolerances of the JAX tests; ms per launch and
    bounds at B=131072."""
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk
    from srbd_nmpc_tpu_torch.utils import opcount

    def calls_for(cand, one, bwd, fwd_in, reg):
        return {
            "sqp_onepass_cand": (
                lambda: sk.sqp_qp_solve_onepass_cand(*cand, reg=reg),
                lambda: sk.sqp_qp_solve_onepass_cand_ref(*cand, reg=reg)),
            "sqp_onepass": (lambda: sk.sqp_qp_solve_onepass(*one, reg=reg),
                            lambda: sk.sqp_qp_solve_onepass_ref(*one,
                                                                reg=reg)),
            "sqp_twopass_bwd": (lambda: sk.sqp_qp_backward(*bwd, reg=reg),
                                lambda: sk.sqp_qp_backward_ref(*bwd, reg=reg)),
            "sqp_twopass_fwd": (lambda: sk.sqp_qp_forward(*fwd_in),
                                lambda: sk.sqp_qp_forward_ref(*fwd_in)),
        }

    rng = np.random.default_rng(13)
    rel, max_abs = {}, {}
    cand, one, bwd, reg = _k3_args(rng, 4096, dev)
    fwd_in = (*sk.sqp_qp_backward_ref(*bwd, reg=reg)[:7], one[9])
    for name, (kern, plain) in calls_for(cand, one, bwd, fwd_in, reg).items():
        rel[name], max_abs[name] = _diff(kern(), plain())
    # K3b against the two-pass oracle on K1's random iterates: printed, not
    # held to the tolerances (both f32 solves sit about half the du
    # tolerance from f64 there, so they can differ by more than it); the
    # two-pass entry sqp_qp_solve (as the tools and tests call it) is K4's
    # own path, so its launches are counted here
    rand_gap = _oracle_gap(sk.sqp_qp_solve_onepass(*one, reg=reg),
                           sk.sqp_qp_solve(*one, reg=reg))
    # ... and held to them on the inputs they were set on
    near, near_reg = _setup_inputs(dev)
    one_k = sk.sqp_qp_solve_onepass(*near, reg=near_reg)
    _reset_counts()
    two_k = sk.sqp_qp_solve(*near, reg=near_reg)
    torch.cuda.synchronize()
    k4_launches = {k: v for k, v in _counts().items() if v}
    if k4_launches != {"sqp_twopass_bwd": 1, "sqp_twopass_fwd": 1}:
        raise AssertionError(f"sqp_qp_solve launches {k4_launches}")
    oracle = _oracle_gap(one_k, two_k)
    del cand, one, bwd, fwd_in, near, one_k, two_k
    print("[13 dense kernels] kernel vs plain at N=20, B=4096: " + ", ".join(
        f"{k} {v:.3e}" for k, v in rel.items()) + f" (limit {REL_TOL:g}); "
        "max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items())
        + f"; K3b vs K4 on the card (launches {k4_launches}), worst "
        "|diff| / (atol + rtol |K4|) on the JAX test's inputs (N=12, B=128): "
        + ", ".join(f"{k} {v:.3f}" for k, v in oracle.items())
        + " (limit 1); on the random iterates above (not held): "
        + ", ".join(f"{k} {v:.3f}" for k, v in rand_gap.items()), flush=True)
    if not all(v < REL_TOL for v in rel.values()):
        raise AssertionError(f"a dense kernel disagrees with its plain "
                             f"version: {rel}")
    if not all(v <= 1.0 for v in oracle.values()):
        raise AssertionError(f"K3b vs K4 outside the f32 tolerances: {oracle}")

    # the main path's full width: each kernel against its plain version
    # again, then timed, and its bound from its inputs, outputs and
    # operations there
    cand, one, bwd, reg = _k3_args(rng, B_MAIN, dev)
    prods = sk.sqp_qp_backward(*bwd, reg=reg)
    fwd_in = (*prods[:7], one[9])
    del prods
    calls = calls_for(cand, one, bwd, fwd_in, reg)
    ins = {"sqp_onepass_cand": cand[6:13], "sqp_onepass": one[6:10],
           "sqp_twopass_bwd": bwd[6:9], "sqp_twopass_fwd": fwd_in}
    ops = {"sqp_onepass_cand": opcount.count_sqp_onepass_cand(*cand, reg=reg),
           "sqp_onepass": opcount.count_sqp_onepass(*one, reg=reg),
           "sqp_twopass_bwd": opcount.count_sqp_twopass_bwd(*bwd, reg=reg),
           "sqp_twopass_fwd": opcount.count_sqp_twopass_fwd(*fwd_in)}
    rel_full, times, bounds = {}, {}, {}
    for name, (kern, plain) in calls.items():
        got = kern()
        rel_full[name], err = _diff(got, plain())
        max_abs[name] = max(max_abs[name], err)
        bounds[name] = _bound(_nbytes(ins[name], got), ops[name])
        del got
        times[name] = (_cuda_ms(kern, 5), _cuda_ms(plain, 1))
    del calls, cand, one, bwd, fwd_in, ins
    torch.cuda.empty_cache()
    print(f"[13 dense kernels] kernel vs plain at B={B_MAIN}: " + ", ".join(
        f"{k} {v:.3e}" for k, v in rel_full.items())
        + f" (limit {REL_TOL:g}); ms per launch, kernel (plain; bound): "
        + ", ".join(
            f"{k} {t[0]:.3f} ({t[1]:.3f}; {bounds[k][0]:.3f} {bounds[k][1]})"
            for k, t in times.items()), flush=True)
    if not all(v < REL_TOL for v in rel_full.values()):
        raise AssertionError(f"a dense kernel disagrees with its plain "
                             f"version at B={B_MAIN}: {rel_full}")
    return max_abs, times, bounds, k4_launches


def _k3_call(name, cand, one, reg):
    """K3a (``name`` "sqp_onepass_cand") or K3b on the card on
    ``_k3_args``' arguments."""
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk

    if name == "sqp_onepass_cand":
        return lambda: sk._k3a_cuda(*cand, reg=reg)
    return lambda: sk._k3b_cuda(*one, reg=reg)


def _k3_split_bytes(N, B, cand):
    """Bytes K3's launches must move per call in float32, each array read
    once and written once by each launch that touches it: K3s-A reads the
    inputs (xa, us, xra; dxc, duc, alpha under cand) and writes the pack
    [N,87,B], the merit terms [N,4,B] and the terminal rows [13,B]; K3s-B
    reads the pack and qN and writes K, kv [N,156,B]; K3s-C reads 63 of the
    pack's channels, the merit terms, the terminal rows, K, kv and dx0, and
    writes dx[1:], du [N,24,B] and the five scalars [5,B]."""
    inputs = 12 * (N + 1) * 2 + 12 * N + (12 * (N + 1) + 12 * N + 1) * cand
    words = (inputs + (87 + 4) * N + 13                  # K3s-A
             + 87 * N + 12 + 156 * N                     # K3s-B
             + (63 + 4 + 156 + 24) * N + 13 + 12 + 5)    # K3s-C
    return 4 * B * words


def phase_k3_designs(dev):
    """K3a and K3b at N=20: each against its plain version at B=4096 and
    B=131072, max |diff| printed, bitwise expected; ms per call at the main
    path's four widths (four rounds of 5 calls); each launch's device ms
    (torch.profiler) at each width; the launches' byte floor."""
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk

    rng = np.random.default_rng(15)
    err = {n: (0.0, 0.0, True) for n in K3_NAMES}
    for B in (4096, B_MAIN):
        cand, one, _, reg = _k3_args(rng, B, dev)
        for name in K3_NAMES:
            ref = (sk.sqp_qp_solve_onepass_cand_ref(*cand, reg=reg)
                   if name == "sqp_onepass_cand"
                   else sk.sqp_qp_solve_onepass_ref(*one, reg=reg))
            got = _k3_call(name, cand, one, reg)()
            torch.cuda.synchronize()
            rel, mx = _diff(got, ref)
            same = all(torch.equal(g, r)
                       for g, r in zip(_flat(got), _flat(ref)))
            print(f"[13 K3] {KERNEL_IDS[name]} vs plain at B={B}: {rel:.3e} "
                  f"(limit {REL_TOL:g}); max |diff| {mx:.3e}; bitwise "
                  f"{same}", flush=True)
            r0, m0, s0 = err[name]
            err[name] = (max(rel, r0), max(mx, m0), same and s0)
            del got, ref
        del cand, one
        torch.cuda.empty_cache()
    bad = {k: v for k, v in err.items() if not v[0] < REL_TOL}
    if bad:
        raise AssertionError(f"K3 disagrees with plain: {bad}")

    # ms per call in four rounds (_rounds, 5 calls each); then each
    # launch's device ms
    times = {n: {} for n in K3_NAMES}
    passes = {n: {} for n in K3_NAMES}
    for B in K1_WIDTHS:
        cand, one, _, reg = _k3_args(rng, B, dev)
        for name in K3_NAMES:
            call = _k3_call(name, cand, one, reg)
            times[name][B] = _rounds({name: call}, 5)[name]
            passes[name][B] = _launch_ms(call, K3S_PASSES)
            del call
        del cand, one
        torch.cuda.empty_cache()
    for name in K3_NAMES:
        print(f"[13 K3] {KERNEL_IDS[name]} ms per call: " + ", ".join(
            f"B={B} {ms:.3f}" for B, ms in times[name].items()), flush=True)
        for B, by in passes[name].items():
            print(f"[13 K3] {KERNEL_IDS[name]} device ms per launch at "
                  f"B={B}: " + ", ".join(
                      f"{p} {v:.3f}" for p, v in by.items()), flush=True)
    floor = {name: _k3_split_bytes(N_MAIN, B_MAIN, name == "sqp_onepass_cand")
             for name in K3_NAMES}
    print(f"[13 K3] bytes the launches move per call at B={B_MAIN}: "
          + ", ".join(f"{KERNEL_IDS[n]} {b / 1e9:.3f} GB, a floor of "
                      f"{b / PEAK_BYTES * 1e3:.3f} ms at "
                      f"{PEAK_BYTES / 1e12:g} TB/s" for n, b in floor.items()),
          flush=True)
    return err, times, passes, floor


def _k4a_split_bytes(N, B):
    """Bytes K4a's launches must move per call in float32, each array read
    once and written once by each launch that touches it: K5's stage pass
    reads x, x_next, u, x_ref (48 words a stage) and writes b, q, r_eff
    (36), the merit rows (8) and the ddb hand-off (24); its dense write
    reads x and u again (18) and the hand-off, and writes A, B, R_eff
    (432); the merit pass reads x_N, x_ref,N (24) and six merit rows a
    stage, and writes q_N (12) and the four merit values; the team pass
    reads A, B (288), R_eff's lower triangle (78), b, q, r_eff (36) and
    q_N, and writes K, kv, Acl, bcl (312)."""
    words = ((48 + 36 + 8 + 24) * N + (18 + 24 + 432) * N
             + 24 + 6 * N + 12 + 4 + (288 + 78 + 36) * N + 12 + 312 * N)
    return 4 * B * words


def _k6a_on_k4a_inputs(bwd, reg):
    """A call of K6a (``riccati_kernel.lqr_backward`` with (Q, Qf)) on the
    stage inputs that K4a hands its team pass, built once here:
    K5's A, B, b, q, r_eff and R_eff at (xa, us), q_N appended to q."""
    from srbd_nmpc_tpu_torch.models import srbd_linearize
    from srbd_nmpc_tpu_torch.ops import riccati_kernel
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk

    params, Q, Qf, R, Ac, bc, xa, us, xra, mu_b, theta_b = bwd
    N = us.shape[0]
    A, Bm, b, q, r, Reff, _ = srbd_linearize.linearize(
        params, Q, R, Ac, bc, xa[:N], xa[1:], us, xra[:N], mu_b, theta_b)
    qN = sk.sqp_qp_backward(*bwd, reg=reg)[6]
    q = torch.cat([q, qN[None]]).contiguous()
    return lambda: riccati_kernel.lqr_backward(A, Bm, b, (Q, Qf), Reff, q, r,
                                               reg)


def phase_k4a_designs(dev):
    """K4a's four launches at N=20: against the plain version at
    K1F_CHECK_WIDTHS on all eleven outputs, max |diff| and a bitwise flag
    printed; ms per call in four rounds at DESIGN_WIDTHS; each launch's
    device ms (one profile a width); the launches' byte floor. Fails unless
    they are bitwise equal to plain at every width. The times are reported
    as they are."""
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk

    rng = np.random.default_rng(21)
    err = (0.0, 0.0, True)
    for B in K1F_CHECK_WIDTHS:
        _, _, bwd, reg = _k3_args(rng, B, dev)
        ref = sk.sqp_qp_backward_ref(*bwd, reg=reg)
        got = sk._k4a_cuda(*bwd, reg=reg)
        torch.cuda.synchronize()
        rel, mx = _diff(got, ref)
        same = all(torch.equal(g, r) for g, r in zip(_flat(got), _flat(ref)))
        print(f"[13 K4a] vs plain at B={B}: {rel:.3e} (limit {REL_TOL:g}); "
              f"max |diff| {mx:.3e}; bitwise {same} (all eleven outputs)",
              flush=True)
        err = (max(rel, err[0]), max(mx, err[1]), same and err[2])
        del got, bwd, ref
        torch.cuda.empty_cache()
    if not err[0] < REL_TOL or not err[2]:
        raise AssertionError(f"K4a disagrees with plain or is not bitwise "
                             f"equal to it: {err}")

    # ms per call in four rounds (_rounds, 5 calls each); then each
    # launch's device ms, and in the same profile K6a's own team kernel on
    # the same stage inputs: the Acl and bcl writes' cost
    times, passes = {}, {}
    k6a = {"K6a team": "riccati_team_kernel"}
    for B in DESIGN_WIDTHS:
        bwd, reg = _k3_args(rng, B, dev)[2:]
        call = lambda: sk._k4a_cuda(*bwd, reg=reg)  # noqa: E731
        times[B] = _rounds({"K4a": call}, 5)["K4a"]
        k6a_call = _k6a_on_k4a_inputs(bwd, reg)
        passes[B] = _launch_ms(lambda: (call(), k6a_call()),
                               {**K4AS_PASSES, **k6a})
        del call, k6a_call, bwd
        torch.cuda.empty_cache()
    print("[13 K4a] ms per call: " + ", ".join(
        f"B={B} {ms:.3f}" for B, ms in times.items()), flush=True)
    for B, by in passes.items():
        k6a_ms = by.pop("K6a team")
        print(f"[13 K4a] device ms per launch at B={B}: "
              + ", ".join(f"{p} {v:.3f}" for p, v in by.items())
              + f"; K6a's own team kernel on the same stage inputs {k6a_ms:.3f}"
              f", so Acl and bcl cost the team pass "
              f"{by['team'] - k6a_ms:.3f} ms", flush=True)
    floor = _k4a_split_bytes(N_MAIN, B_MAIN)
    print(f"[13 K4a] bytes the launches move per call at B={B_MAIN}: "
          f"{floor / 1e9:.3f} GB, a floor of {floor / PEAK_BYTES * 1e3:.3f} "
          f"ms at {PEAK_BYTES / 1e12:g} TB/s", flush=True)
    return err, times, passes, floor


def phase_dense(dev, card, spec):
    """Cold B=131072 solves of the dense one-pass route on both loops, read
    against the speculative planes path (phase 5); then the dense
    speculative solve's compaction, bitwise, at B=8192."""
    from srbd_nmpc_tpu_torch.parallel import sharded

    n_spec, it_spec = spec
    out = {}
    for loop, kw in DENSE_ROUTES.items():
        prob = _route_problem(dev, B_MAIN, kw)
        torch.cuda.synchronize()
        _reset_counts()
        st, info, summ = sharded.solve_batch(*prob)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _counts().items() if v}
        n_conv, mean_it = int(summ.n_converged), float(summ.mean_iters)
        loops = int(info.sqp_iters.max())
        trips = int(info.ls_trips[0])
        u_ok = bool(torch.isfinite(st.u[info.converged]).all())
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sharded.solve_batch(*prob)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.percentile(times, 50))
        # where the time goes: one more solve under the profiler
        by_name, _ = _device_ms(lambda: sharded.solve_batch(*prob))
        busy = sum(by_name.values())
        # K3's device kernels: its launches (K3s-B is K1s-B's kernel, which
        # this route runs for K3 alone)
        k3 = {k: v for k, v in by_name.items()
              if any(key in k for key in K3S_PASSES.values())}
        d_conv, d_it = n_conv - n_spec, mean_it - it_spec
        what = ("trips (bootstrap included)" if loop == "spec"
                else "line-search trips")
        print(f"[14 dense] {loop} (planes=False, {kw}) B={B_MAIN}: converged "
              f"{n_conv}/{B_MAIN} ({d_conv:+d} vs phase 5), mean SQP "
              f"iterations {mean_it:.4f} ({d_it:+.4f}), SQP loops {loops}, "
              f"{what} {trips}, launches {launches}; p50 {p50:.3f} ms per "
              "solve, "
              f"{B_MAIN / p50 * 1e3:.1f} solves/s (times "
              f"{[round(t, 3) for t in times]}) on {card}", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"[14 dense] {loop} profiled solve: device busy {busy:.3f} ms "
              f"({100 * busy / p50:.1f} % of the p50, so idle "
              f"{100 * (1 - busy / p50):.1f} %), K3 {sum(k3.values()):.3f} ms "
              f"({len(k3)} kernel names); "
              "top kernels " + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top),
              flush=True)
        if loop == "spec":
            ok = (launches.get("sqp_onepass") == 1
                  and launches.get("sqp_onepass_cand") == trips - 1
                  and launches.get("take_lanes", 0) > 0
                  and launches.get("set_lanes", 0) > 0)
        else:
            ok = (launches.get("sqp_onepass", 0) > 0
                  and launches.get("merit_alpha", 0) > 0)
        if not ok or launches.get("sqp_planes"):
            raise AssertionError(f"dense {loop}: launches {launches}")
        if not u_ok:
            raise AssertionError(f"dense {loop}: a converged solution is "
                                 "not finite")
        if abs(d_conv) > SYNC_CONV_FRAC * B_MAIN or abs(d_it) > SYNC_ITER_TOL:
            raise AssertionError(f"dense {loop}: converged {d_conv:+d}, mean "
                                 f"iterations {d_it:+.4f} vs phase 5")
        out[loop] = dict(launches=launches, n_conv=n_conv, mean_it=mean_it,
                         loops=loops, trips=trips, p50=p50)
        del prob, st, info
        torch.cuda.empty_cache()

    # K3a at the speculative loop's tier widths (as phase 4 times K1)
    from srbd_nmpc_tpu_torch.ops import sqp_kernel as sk

    widths = {}
    for B in (B_MAIN // 2, B_MAIN // 8, B_MAIN // 32):
        cand, _, _, reg = _k3_args(np.random.default_rng(14), B, dev)
        widths[B] = _cuda_ms(
            lambda: sk.sqp_qp_solve_onepass_cand(*cand, reg=reg), 5)
    del cand
    print("[14 dense] K3a ms per launch at the tier widths: " + ", ".join(
        f"B={B} {ms:.3f}" for B, ms in widths.items()), flush=True)

    B = 8192
    res = [sharded.solve_batch(*_route_problem(
        dev, B, dict(DENSE_ROUTES["spec"], compact=c))) for c in (True, False)]
    torch.cuda.synchronize()
    (st_c, in_c, _), (st_f, in_f, _) = res
    same = (torch.equal(st_c.u, st_f.u) and torch.equal(st_c.x, st_f.x)
            and torch.equal(in_c.sqp_iters, in_f.sqp_iters)
            and torch.equal(in_c.status, in_f.status))
    print(f"[14 dense] B={B}: dense compact=True vs compact=False bitwise "
          f"equal: {same}", flush=True)
    if not same:
        raise AssertionError("compacted dense solve differs from the "
                             "full-width one")
    return out


def _ptxas(source: str, needle: str, log=None):
    """(registers, spill stores, spill loads, stack bytes) of the kernels
    of ``source`` whose mangled name contains ``needle``, from nvcc's
    ``-Xptxas -v`` report (of the current build, or ``log``), one tuple per
    such kernel."""
    import re

    from srbd_nmpc_tpu_torch.utils import build

    out, cur = [], None
    for ln in (log or build.build_log(source)).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1) if needle in m.group(1) else None
            stack = stores = loads = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            stack, stores, loads = (int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append((cur, int(m.group(1)), stores, loads, stack))
            cur = None
    return out


def _k7b_inputs(rng, B, dev, kind):
    """K7b arguments at width B: the cold problem's iterate (x = 0,
    u = 100, as ``NmpcState.initial``) or random iterates (x ~ 0.1 N(0,1),
    u ~ 90 + 20 N(0,1), as tools/profile_stages.py draws them), with the
    benchmark reference broadcast over the batch."""
    from srbd_nmpc_tpu_torch.models import srbd
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

    params, weights, cfg = build_from_options(MpcOptions.default(), device=dev)
    _, x_ref = engine.make_benchmark_problem(cfg, device=dev)
    N = cfg.N
    f32 = torch.float32
    if kind == "cold":
        x = torch.zeros((N + 1, 12, B), dtype=f32, device=dev)
        u = torch.full((N, 12, B), 100.0, dtype=f32, device=dev)
    else:
        x = torch.as_tensor(0.1 * rng.normal(size=(N + 1, 12, B)), dtype=f32,
                            device=dev)
        u = torch.as_tensor(90 + 20 * rng.normal(size=(N, 12, B)), dtype=f32,
                            device=dev)
    xr = x_ref[:, :, None].expand(N + 1, 12, B).contiguous()
    Ac, bc = srbd.constraint_matrix(params)
    return ((params, weights.Q, weights.Qf, weights.R, Ac, bc, x, u, xr,
             cfg.mu_barrier, cfg.theta_barrier), (params, weights, cfg, x_ref))


K7B = {"merit": True, "merit_nograd": False}


def phase_k7b(dev):
    """K7b, both variants, against its plain version at N=20 on the cold
    iterate and on random iterates at B=4096 and B=131072; then its path,
    ``engine._merit_fast`` with ``qp_kernel="auto"``, at B=131072 (launch
    counts, and its outputs against the plain ``merit`` the ``xla`` setting
    takes); ms per launch, registers and spills, bounds."""
    import dataclasses

    from srbd_nmpc_tpu_torch.models import merit_kernel
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.utils import opcount

    rng = np.random.default_rng(15)
    rel = {k: 0.0 for k in K7B}
    max_abs = {k: 0.0 for k in K7B}
    for B in (4096, B_MAIN):
        for kind in ("cold", "random"):
            args, _ = _k7b_inputs(rng, B, dev, kind)
            for name, g in K7B.items():
                got = [t for t in merit_kernel.merit(*args, with_grad=g)
                       if t is not None]
                ref = [t for t in merit_kernel.merit_ref(*args, with_grad=g)
                       if t is not None]
                r, a = _diff(got, ref)
                rel[name] = max(rel[name], r)
                max_abs[name] = max(max_abs[name], a)
                del got, ref
            del args
    torch.cuda.empty_cache()
    print(f"[15 K7b] kernel vs plain at N=20, B=4096 and B={B_MAIN}, cold and "
          "random iterates: " + ", ".join(
              f"{k} {v:.3e} (max |diff| {max_abs[k]:.3e})"
              for k, v in rel.items()) + f" (limit {REL_TOL:g})", flush=True)
    if not all(v < REL_TOL for v in rel.values()):
        raise AssertionError(f"K7b disagrees with its plain version: {rel}")

    # the path: the batched merit entry point on AoS states [B, N+1, 12]
    args, (params, weights, cfg, x_ref) = _k7b_inputs(rng, B_MAIN, dev,
                                                      "random")
    x = args[6].permute(2, 0, 1).contiguous()
    u = args[7].permute(2, 0, 1).contiguous()
    assert cfg.qp_kernel == "auto"
    torch.cuda.synchronize()
    _reset_counts()
    path = {g: engine._merit_fast(params, weights, cfg, x, u, x_ref,
                                  with_grad=g) for g in (True, False)}
    torch.cuda.synchronize()
    launches = {k: v for k, v in _counts().items() if v}
    plain_cfg = dataclasses.replace(cfg, qp_kernel="xla")
    path_rel = max(_diff(path[g], engine._merit_fast(
        params, weights, plain_cfg, x, u, x_ref, with_grad=g))[0]
        for g in (True, False))
    del path, x, u
    print(f"[15 K7b] engine._merit_fast (qp_kernel='auto') at B={B_MAIN}: "
          f"launches {launches}; against the plain merit (qp_kernel='xla') "
          f"{path_rel:.3e} (limit {REL_TOL:g})", flush=True)
    if launches != {"merit": 1, "merit_nograd": 1}:
        raise AssertionError(f"_merit_fast launches {launches}")
    if not path_rel < REL_TOL:
        raise AssertionError(f"_merit_fast vs plain merit: {path_rel}")

    times, bounds = {}, {}
    for name, g in K7B.items():
        out = merit_kernel.merit(*args, with_grad=g)
        bounds[name] = _bound(_nbytes(args[6:9], out),
                              opcount.count_merit(*args, with_grad=g))
        del out
        times[name] = (_cuda_ms(lambda: merit_kernel.merit(*args, with_grad=g),
                                20),
                       _cuda_ms(lambda: merit_kernel.merit_ref(
                           *args, with_grad=g), 1))
    regs = _ptxas("merit", "merit_kernel")
    del args
    torch.cuda.empty_cache()
    print(f"[15 K7b] ms per launch at B={B_MAIN}, kernel (plain; bound): "
          + ", ".join(f"{k} {t[0]:.4f} ({t[1]:.3f}; {bounds[k][0]:.4f} "
                      f"{bounds[k][1]})" for k, t in times.items())
          + "; ptxas: " + ", ".join(
              f"{n[:24]} {r} registers, {st} B spill stores, {ld} B spill "
              f"loads, {sk} B stack" for n, r, st, ld, sk in regs), flush=True)
    return max_abs, times, bounds, launches


# f32 single scenario, card vs CPU: max |u - u_cpu| in N (forces ~100 N);
# about 10x the 2.289e-05 N measured on an H100 (PERF.md, PR 4)
U32_TOL = 2.5e-4


def _single_problem(dev, dtype, **kw):
    """The reference problem for one robot (``MpcOptions.default()``: N=20,
    dt=0.015, at most 15 SQP iterations; the benchmark reference step) on
    ``dev``, states [N+1, 12]."""
    import dataclasses

    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

    params, weights, cfg = build_from_options(MpcOptions.default(),
                                              dtype=dtype, device=dev)
    cfg = dataclasses.replace(cfg, **kw)
    x0, x_ref = engine.make_benchmark_problem(cfg, dtype, device=dev)
    return (params, weights, cfg,
            engine.NmpcState.initial(cfg.N, dtype, device=dev), x0, x_ref)


def _timed_solve(prob):
    from srbd_nmpc_tpu_torch.nmpc import engine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.solve(*prob)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_single(dev, card):
    """The single-scenario solve on the card: f64 against the CPU and the
    f64 C++ oracle, f32 with one refinement pass against the CPU and the
    oracle, exact sensitivities; cold and warm (20 repetitions from the
    converged state) solve times."""
    from srbd_nmpc_tpu_torch.nmpc import engine
    from srbd_nmpc_tpu_torch.utils.metrics import oracle_solve, parity_metric

    f64, f32 = torch.float64, torch.float32
    prob = _single_problem(dev, f64)
    _timed_solve(prob)                       # first call: handles, caches
    _reset_counts()
    cold = [_timed_solve(prob) for _ in range(3)]
    launches = {k: v for k, v in _counts().items() if v}
    (st, info), _ = cold[0]
    cold_ms = float(np.percentile([t for _, t in cold], 50))
    # the same solve on this machine's CPU: the reference for the card's
    # iterations and u, and its time beside the card's
    cpu = [_timed_solve(_single_problem("cpu", f64)) for _ in range(3)]
    (st_c, info_c), _ = cpu[0]
    cpu_ms = float(np.percentile([t for _, t in cpu], 50))
    same ={k: (int(getattr(info, k)), int(getattr(info_c, k)))
            for k in ("sqp_iters", "status", "ls_trips")}
    du_cpu = float((st.u.cpu() - st_c.u).abs().max())
    ok, x_o, u_o = oracle_solve(prob[4].cpu().numpy())
    err_u = float(np.max(np.abs(st.u.cpu().numpy() - u_o)))
    err_x = float(np.max(np.abs(st.x.cpu().numpy() - x_o)))
    par = parity_metric(st.u.cpu().numpy(), u_o)

    params, weights, cfg, _, x0, x_ref = prob
    warm = [_timed_solve((params, weights, cfg, st, x0, x_ref))
            for _ in range(20)]
    warm_iters = sorted({int(i.sqp_iters) for (_, i), _ in warm})
    warm_conv = all(bool(i.converged) for (_, i), _ in warm)
    warm_ms = float(np.percentile([t for _, t in warm], 50))
    # where the time goes: one cold and one warm solve under the profiler
    prof = {}
    for name, p_ms, start in (("cold", cold_ms, prob[3]), ("warm", warm_ms, st)):
        by_name, n = _device_ms(
            lambda: engine.solve(params, weights, cfg, start, x0, x_ref))
        busy = sum(by_name.values())
        prof[name] = (f"{n} device kernels, busy {busy:.3f} ms (idle "
                      f"{100 * (1 - busy / p_ms):.1f} % of the p50)")
    print(f"[16 single] f64 on {card}: converged {bool(info.converged)}, "
          f"status {int(info.status)}, SQP iterations/status/trips card vs "
          f"CPU {same}, max |u - u_cpu| {du_cpu:.3e} (limit 1e-8); vs the f64 "
          f"oracle (converged {ok}): err_u/100 {err_u / 100:.3e}, err_x "
          f"{err_x:.3e} (limits 1e-4), parity_metric {par:.3e}; kernel "
          f"launches {launches}; cold solve p50 {cold_ms:.3f} ms (of 3: "
          f"{[round(t, 3) for _, t in cold]}; the CPU's {cpu_ms:.3f}); warm "
          f"p50 {warm_ms:.3f} ms over "
          f"20 repetitions, SQP iterations {warm_iters}; profiled: cold "
          f"{prof['cold']}, warm {prof['warm']}", flush=True)
    if not (bool(info.converged) and all(a == b for a, b in same.values())
            and du_cpu < 1e-8 and ok and err_u / 100 < 1e-4 and err_x < 1e-4):
        raise AssertionError(f"single-scenario f64 solve: {same}, {du_cpu}, "
                             f"{err_u}, {err_x}")
    if not (warm_conv and warm_iters == [1]):
        raise AssertionError(f"warm solves: converged {warm_conv}, "
                             f"iterations {warm_iters}")
    if launches:
        raise AssertionError(f"the single-scenario solve launched {launches}")

    prob32 = _single_problem(dev, f32, refine=1)
    _timed_solve(prob32)
    (st32, info32), cold32 = _timed_solve(prob32)
    warm32 = [_timed_solve((*prob32[:3], st32, *prob32[4:]))[1]
              for _ in range(20)]
    err32 = float(np.max(np.abs(st32.u.cpu().double().numpy() - u_o)))
    # the same f32 solve on the CPU: a lost refinement pass or a lower
    # precision on the card shows here long before it reaches the oracle bar
    (st32_c, info32_c), _ = _timed_solve(_single_problem("cpu", f32, refine=1))
    same32 = {k: (int(getattr(info32, k)), int(getattr(info32_c, k)))
              for k in ("sqp_iters", "status", "ls_trips")}
    du32 = float((st32.u.cpu() - st32_c.u).abs().max())
    (st_x, info_x), exact_ms = _timed_solve(
        _single_problem(dev, f64, sensitivity="exact", persistent_alpha=False))
    print(f"[16 single] f32 refine=1: status {int(info32.status)}, SQP "
          f"iterations {int(info32.sqp_iters)}, err_u/100 vs oracle "
          f"{err32 / 100:.3e} (limit 1e-3); SQP iterations/status/trips card "
          f"vs CPU {same32}, max |u - u_cpu| {du32:.3e} (limit {U32_TOL:g}); "
          f"cold {cold32:.3f} ms, warm p50 "
          f"{float(np.percentile(warm32, 50)):.3f} ms. Exact sensitivities "
          f"(f64, alpha reset): converged {bool(info_x.converged)} in "
          f"{int(info_x.sqp_iters)} iterations, phi {float(info_x.phi):.6f} "
          f"vs Euler {float(info.phi):.6f}; cold {exact_ms:.3f} ms",
          flush=True)
    if not (err32 / 100 < 1e-3 and all(a == b for a, b in same32.values())
            and du32 < U32_TOL):
        raise AssertionError(f"f32 single-scenario: vs oracle {err32}, vs "
                             f"CPU {same32}, {du32}")
    if not (bool(info_x.converged)
            and float(info_x.phi) <= float(info.phi) + 1e-6):
        raise AssertionError("exact sensitivities: converged "
                             f"{bool(info_x.converged)}, phi "
                             f"{float(info_x.phi)} vs {float(info.phi)}")
    return dict(cold_ms=cold_ms, warm_ms=warm_ms, cold32_ms=cold32,
                warm32_ms=float(np.percentile(warm32, 50)), exact_ms=exact_ms)


def phase_exact_batched(dev, card):
    """The batched exact-sensitivity route (``sensitivity="exact"`` takes
    the plain ``xla`` route) at B=4096, f32, refine=1, alpha reset, against
    the CPU plain run of its first 64 scenarios."""
    from srbd_nmpc_tpu_torch.parallel import sharded
    from srbd_nmpc_tpu_torch.utils.metrics import parity_metric

    B, S = 4096, 64
    kw = dict(sensitivity="exact", refine=1, persistent_alpha=False)
    prob = _route_problem(dev, B, kw, seed=9)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    st, info, summ = sharded.solve_batch(*prob)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in _counts().items() if v}
    params, weights, cfg, states, _, x_ref = _route_problem("cpu", S, kw)
    st_c, in_c, _ = sharded.solve_batch(params, weights, cfg, states,
                                        prob[4][:S].cpu(), x_ref)
    both = (info.converged[:S].cpu() & in_c.converged).numpy()
    same = both & (info.sqp_iters[:S].cpu() == in_c.sqp_iters).numpy()
    flips = int(both.sum() - same.sum())
    err = parity_metric(st.u[:S].cpu().numpy()[same], st_c.u.numpy()[same])
    n_conv = int(summ.n_converged)
    print(f"[16b exact] batched sensitivity='exact' (xla route, f32, refine=1, "
          f"alpha reset) B={B}: converged {n_conv}/{B} "
          f"({100 * n_conv / B:.2f} %), mean SQP iterations "
          f"{float(summ.mean_iters):.4f}, {ms:.1f} ms, launches {launches}; "
          f"first {S} vs the CPU plain run: converged in both {int(both.sum())}, "
          f"{flips} at another iteration, relative u error {err:.3e} over "
          f"{int(same.sum())} (limit {REL_TOL:g}) on {card}", flush=True)
    if not (same.sum() > 0 and err < REL_TOL and flips <= 1):
        raise AssertionError(f"exact route vs CPU: {err}, {flips} flips")
    if launches:
        raise AssertionError(f"the xla route launched {launches}")
    return dict(n_conv=n_conv, ms=ms)


def _k3_ptxas(k1):
    """(registers, spill stores, spill loads, stack bytes) of K3's launches
    (sqp_onepass.cu's K3s-A <true>/<false> and K3s-C; K3s-B is K1s-B, from
    ``k1``)."""
    out = {}
    for mangled, regs, stores, loads, stack in _ptxas("sqp_onepass", "k3s_"):
        tag = "true" if "ILb1E" in mangled else "false"
        name = ("K3s-A <" + tag + ">" if "k3s_planes_kernel" in mangled
                else "K3s-C")
        out[name] = (regs, stores, loads, stack)
    out["K3s-B"] = k1["K1s-B"]
    want = {"K3s-A <true>", "K3s-A <false>", "K3s-B", "K3s-C"}
    if set(out) != want:
        raise AssertionError(f"K3 kernels in the ptxas report: {out}")
    return out


def _k1s_ptxas():
    """(registers, spill stores, spill loads, stack bytes) of each kernel of
    K1's three bodies (sqp_planes.cu): K1s-A, K1s-B, K1s-C, the factor forms
    of the last two, the rank-6 form of K1s-B and the float64 forms of the
    gains body's three."""
    passes = {**K1S_PASSES, **K1FS_PASSES,
              "K1s-B rank-6": K1RS_PASSES["K1s-B rank-6"], **K1S_F64_PASSES}
    out = {}
    for mangled, regs, stores, loads, stack in _ptxas("sqp_planes", "k1s_"):
        name = next((p for p, key in passes.items() if key in mangled),
                    mangled)
        out[name] = (regs, stores, loads, stack)
    want = set(passes)
    if set(out) != want:
        raise AssertionError(f"K1 kernels in the ptxas report: {out}")
    for p, key in passes.items():
        if key in K1S_B_PTXAS:
            regs, stores = out[p][:2]
            rec = K1S_B_PTXAS[key]
            print(f"[2 build] {p} {regs} registers, {stores} B spill stores "
                  f"against the recorded {rec[0]} and {rec[1]} B: unchanged "
                  f"{(regs, stores) == rec}", flush=True)
    return out


def _k6_ptxas():
    """(registers, spill stores, spill loads, stack bytes) of K6's backward
    team kernel (riccati.cu), <true> (K6a, const Q) and <false> (K6b,
    per-stage Q)."""
    out = {}
    for mangled, regs, stores, loads, stack in _ptxas("riccati",
                                                      "riccati_team_kernel"):
        tag = "true" if "ILb1E" in mangled else "false"
        out[f"team <{tag}>"] = (regs, stores, loads, stack)
    if sorted(out) != ["team <false>", "team <true>"]:
        raise AssertionError(f"K6 kernels in the ptxas report: {out}")
    print("[2 build] K6's team kernel against the recorded ptxas: " + ", ".join(
        f"{n} {out[n][0]} registers, {out[n][1]} B spill stores (recorded "
        f"{r} and {st} B): unchanged {out[n][:2] == (r, st)}"
        for n, (r, st) in K6_TEAM_PTXAS.items()), flush=True)
    return out


def _k4a_ptxas():
    """(registers, spill stores, spill loads, stack bytes) of K4a's
    launches (K5's two from linearize.cu, the merit pass from
    sqp_twopass.cu, the team pass from riccati.cu)."""
    out = {}
    for name, source, key in (
            (p, "linearize" if p.startswith("K5") else
             "sqp_twopass" if p == "merit" else "riccati", key)
            for p, key in K4AS_PASSES.items()):
        found = _ptxas(source, key)
        if len(found) != 1:
            raise AssertionError(f"{key} in the ptxas report: {found}")
        out[name] = found[0][1:]
    return out


def _k5_k7a_ptxas():
    """(registers, spill stores, spill loads, stack bytes) of K5's and K7a's
    launches (linearize.cu, merit.cu) by "<id> <pass>"."""
    out = {}
    for kid, source, passes in (("K5", "linearize", K5_PASSES),
                                ("K7a", "merit", K7A_PASSES)):
        for p, key in passes.items():
            found = _ptxas(source, key)
            if len(found) != 1:
                raise AssertionError(f"{key} in the ptxas report: {found}")
            out[f"{kid} {p}"] = found[0][1:]
    return out


def phase_factor(dev, card, spec):
    """Cold B=131072 solves with ``park_factor=True`` (K1's factor body) on
    the speculative loop and the synchronous ``fused`` route, read against
    the speculative path's default cold solve (phase 5)."""
    from srbd_nmpc_tpu_torch.parallel import sharded

    n_spec, it_spec = spec
    out = {}
    for loop, kw in FACTOR_ROUTES.items():
        prob = _route_problem(dev, B_MAIN, kw)
        torch.cuda.synchronize()
        _reset_counts()
        st, info, summ = sharded.solve_batch(*prob)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _counts().items() if v}
        n_conv, mean_it = int(summ.n_converged), float(summ.mean_iters)
        loops = int(info.sqp_iters.max())
        trips = int(info.ls_trips[0])
        u_ok = bool(torch.isfinite(st.u[info.converged]).all())
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sharded.solve_batch(*prob)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.percentile(times, 50))
        d_conv, d_it = n_conv - n_spec, mean_it - it_spec
        what = ("trips (bootstrap included)" if loop == "spec"
                else "line-search trips")
        print(f"[17 factor] {loop} ({kw}) B={B_MAIN}: converged "
              f"{n_conv}/{B_MAIN} ({d_conv:+d} vs phase 5), mean SQP "
              f"iterations {mean_it:.4f} ({d_it:+.4f}), SQP loops {loops}, "
              f"{what} {trips}, launches {launches}; p50 {p50:.3f} ms per "
              f"solve, {B_MAIN / p50 * 1e3:.1f} solves/s (times "
              f"{[round(t, 3) for t in times]}) on {card}", flush=True)
        # where the time goes: one more solve under the profiler, the
        # factor body's device time by launch
        by_name, n = _device_ms(lambda: sharded.solve_batch(*prob))
        busy = sum(by_name.values())
        k1 = {p: sum(v for k, v in by_name.items() if key in k)
              for p, key in K1FS_PASSES.items()}
        print(f"[17 factor] {loop} profiled solve: {n} device kernels, busy "
              f"{busy:.3f} ms; K1 (factor) {sum(k1.values()):.3f} ms "
              f"({100 * sum(k1.values()) / busy:.1f} % of device time): "
              + ", ".join(f"{p} {v:.3f} ({100 * v / busy:.1f} %)"
                          for p, v in k1.items()), flush=True)
        # one factor-body launch per trip (speculative) or per SQP loop
        want = trips if loop == "spec" else loops
        k1 = {k: v for k, v in launches.items() if k.startswith("sqp_planes")}
        if k1 != {"sqp_planes_factor": want}:
            raise AssertionError(f"park_factor {loop}: K1 launches {k1}, "
                                 f"expected {want} of the factor body")
        if not u_ok:
            raise AssertionError(f"park_factor {loop}: a converged solution "
                                 "is not finite")
        if abs(d_conv) > SYNC_CONV_FRAC * B_MAIN or abs(d_it) > SYNC_ITER_TOL:
            raise AssertionError(f"park_factor {loop}: converged {d_conv:+d}, "
                                 f"mean iterations {d_it:+.4f} vs phase 5")
        out[loop] = dict(launches=launches, n_conv=n_conv, mean_it=mean_it,
                         loops=loops, trips=trips, p50=p50)
        del prob, st, info
        torch.cuda.empty_cache()
    return out


def _device_ms(fn, counts=None):
    """Device ms by kernel name of one ``fn()`` under torch.profiler, and
    the number of device kernels it ran (by name into ``counts``, where
    given). Kernels run on one stream, so their sum is the device busy time
    (the profiled call's wall time includes the profiler's own start-up and
    is not used). The profiler keeps only the kernel records whose times,
    moved from the card's clock to the host's, fall inside its window, and
    on the card's machine those times can sit a second away from the
    launches: the window is held open PROFILE_PAD_S on either side of
    ``fn()`` (``_launch_ms`` counts the kernels it keeps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    by_name, n = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
            n += e.count
            if counts is not None:
                counts[e.key] = counts.get(e.key, 0) + e.count
    return by_name, n


def _launch_ms(call, passes, reps=5, tries=3):
    """Device ms per launch of each of ``passes`` (name: a key of its
    kernel's name) over ``reps`` profiled runs of ``call``. A profile that
    does not hold ``reps`` kernels of each pass lost records and would read
    low: it is said so and taken again, at most ``tries`` times in all."""
    for attempt in range(tries):
        counts = {}
        by_name, _ = _device_ms(lambda: [call() for _ in range(reps)], counts)
        seen = {p: sum(n for k, n in counts.items() if key in k)
                for p, key in passes.items()}
        if all(n == reps for n in seen.values()):
            return {p: sum(v for k, v in by_name.items() if key in k) / reps
                    for p, key in passes.items()}
        print(f"[device ms] the profile of {reps} runs held {seen} kernels "
              f"by launch (try {attempt + 1} of {tries})", flush=True)
    raise AssertionError(f"the profiler lost kernel records {tries} times: "
                         f"{seen}")


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound, library_ms=None, **extra):
    return {"name": name, "id": KERNEL_IDS[name], "route": "cuda",
            "source": f"srbd_nmpc_tpu_torch/csrc/{source}",
            "replaces": f"srbd_nmpc_tpu/{replaces}", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, **extra}


def _launch_rows(passes, by_width, regs):
    """A row for each launch of a kernel (``passes``: pass name to kernel
    name): device ms at full width and by width (``by_width``: width to ms
    by pass) and its ptxas report (``regs`` by pass)."""
    return [{"pass": p, "kernel": key, "ms": by_width[B_MAIN][p],
             "ms_by_width": {str(B): by[p] for B, by in by_width.items()},
             "registers": r, "spill_stores": st, "spill_loads": ld,
             "stack": sk}
            for p, key in passes.items() for r, st, ld, sk in [regs[p]]]


def _worst(per):
    """The row's registers and spills: the largest of its launches'."""
    return {k: max(e[k] for e in per)
            for k in ("registers", "spill_stores", "spill_loads")}


def _k1_entry(launches, err, t, plain, bound, regs, d_err, d_passes):
    """K1's row: the default gains path, timed through the public entry in
    phase 4, its largest difference from the plain version over phase 4's
    checks, and a row for each of its launches (device ms by width, ptxas
    report)."""
    per = _launch_rows(K1S_PASSES, d_passes, regs)
    return _entry("sqp_planes", "sqp_planes.cu", "ops/sqp_planes.py:301",
                  launches, max(err, d_err[1]), t[B_MAIN], plain, bound,
                  ms_by_width={str(B): v for B, v in t.items()},
                  **_worst(per), launches_per_call=per)


def _k1_factor_entry(launches, err, t, plain, bound, regs, d_err, d_t,
                     d_passes, floor):
    """K1_factor's row: the park_factor path, timed through the public
    entry in phase 4, its largest difference from the plain version over
    phase 4's checks, and a row for each of its launches (device ms by
    width, ptxas report). The gains body's ms and the floor that the bytes
    of its launches put under it beside them."""
    per = _launch_rows(K1FS_PASSES, d_passes["factor"], regs)
    return _entry("sqp_planes_factor", "sqp_planes.cu",
                  "ops/sqp_planes.py:373", launches, max(err, d_err[1]),
                  t[B_MAIN], plain, bound,
                  ms_by_width={str(B): v for B, v in t.items()},
                  gains_ms_by_width={
                      str(B): v for B, v in d_t["gains"].items()},
                  **_worst(per), split_bytes=floor["factor"],
                  split_bytes_floor_ms=floor["factor"] / PEAK_BYTES * 1e3,
                  launches_per_call=per)


def _k1_rank6_entry(launches, err, t, plain, bound, regs, d_err, d_t,
                    d_passes, floor):
    """K1_rank6's row: ``rank6=True`` (K and kv written by the block), timed
    through the public entry in phase 4, its largest difference from the
    plain version over phase 4's checks, and a row for each of its launches
    (device ms at DESIGN_WIDTHS, ptxas report); the launches' byte floor
    beside them."""
    per = _launch_rows(K1RS_PASSES, d_passes, regs)
    return _entry("sqp_planes_rank6", "sqp_planes.cu", "ops/sqp_planes.py:77",
                  launches, max(err, d_err[1]), t[B_MAIN], plain, bound,
                  ms_by_width={str(B): v for B, v in t.items()},
                  **_worst(per), split_bytes=floor,
                  split_bytes_floor_ms=floor / PEAK_BYTES * 1e3,
                  launches_per_call=per)


def _k4a_extra(regs, d_err, d_t, d_passes, floor):
    """The keys that K4a's row adds: a row for each of its launches (device
    ms at DESIGN_WIDTHS, ptxas report), their sources, its byte floor and
    largest difference from plain over the K4a section's checks
    (``design_err``, folded into the row's max_abs_err)."""
    per = _launch_rows(K4AS_PASSES, d_passes, regs)
    return dict(split_sources=[f"srbd_nmpc_tpu_torch/csrc/{n}" for n in
                               ("linearize.cu", "sqp_twopass.cu",
                                "riccati.cu")],
                ms_by_width={str(B): v for B, v in d_t.items()},
                **_worst(per), split_bytes=floor,
                split_bytes_floor_ms=floor / PEAK_BYTES * 1e3,
                launches_per_call=per, design_err=d_err[1])


def _k3_entry(name, replaces, launches, err, t, plain, bound, regs, d_err,
              d_t, d_passes, floor):
    """K3a's or K3b's row: the dense route's path, timed through the public
    entry in phase 13, its largest difference from the plain version over
    phase 13's checks, and a row for each of its launches (device ms by
    width, ptxas report); the floor that the bytes of its launches put
    under it."""
    tag = "true" if name == "sqp_onepass_cand" else "false"
    per = [{"pass": p, "kernel": key, "ms": d_passes[name][B_MAIN][p],
            "ms_by_width": {str(B): by[p]
                            for B, by in d_passes[name].items()},
            "registers": r, "spill_stores": st, "spill_loads": ld,
            "stack": sk}
           for p, key in K3S_PASSES.items()
           for r, st, ld, sk in [regs[f"{p} <{tag}>" if p == "K3s-A"
                                      else p]]]
    return _entry(name, "sqp_onepass.cu", replaces, launches,
                  max(err, d_err[name][1]), t, plain, bound,
                  ms_by_width={str(B): v for B, v in d_t[name].items()},
                  **_worst(per), split_bytes=floor[name],
                  split_bytes_floor_ms=floor[name] / PEAK_BYTES * 1e3,
                  launches_per_call=per)


def _k6_extra(name, regs, d_err, d_t, d_dev):
    """The keys that K6a's or K6b's row adds: the team kernel's (the pallas
    route's) ms and device ms by width, ptxas report and largest difference
    from plain over phase 10b's checks (``design_err``, folded into the
    row's max_abs_err)."""
    tag = "true" if name == "riccati_bwd_constq" else "false"
    r, st, ld, sk = regs[f"team <{tag}>"]
    return dict(design="team",
                ms_by_width={str(B): v for B, v in d_t[name].items()},
                device_ms_by_width={str(B): v for B, v in d_dev[name].items()},
                registers=r, spill_stores=st, spill_loads=ld, stack=sk,
                design_err=d_err[name][1])


def _k5_k7a_extra(name, regs, d_err, d_t, d_dev, floor):
    """The keys that K5's or K7a's row adds: its ms by width, a row for each
    of its launches (device ms by width, ptxas report), its byte floor and
    largest difference from plain over phase 10c's checks (``design_err``,
    folded into the row's max_abs_err)."""
    kid, passes = (("K5", K5_PASSES) if name == "linearize"
                   else ("K7a", K7A_PASSES))
    per = _launch_rows(passes, d_dev[kid],
                       {p: regs[f"{kid} {p}"] for p in passes})
    return dict(ms_by_width={str(B): v for B, v in d_t[kid].items()},
                split_bytes=floor[kid],
                split_bytes_floor_ms=floor[kid] / PEAK_BYTES * 1e3,
                launches_per_call=per, **_worst(per),
                design_err=d_err[kid][1])


# the TPU kernels' ids (PERF.md's table) by the port's counter names
KERNEL_IDS = {"sqp_planes": "K1", "sqp_planes_rank6": "K1_rank6",
              "sqp_planes_factor": "K1_factor",
              "take_lanes": "K2a", "set_lanes": "K2b",
              "sqp_onepass_cand": "K3a", "sqp_onepass": "K3b",
              "sqp_twopass_bwd": "K4a", "sqp_twopass_fwd": "K4b",
              "linearize": "K5", "riccati_bwd_constq": "K6a",
              "riccati_bwd": "K6b", "riccati_fwd": "K6c",
              "merit_alpha": "K7a", "merit": "K7b", "merit_nograd": "K7b_nograd"}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k2-only", action="store_true",
                    help="build permute.cu and run phases 1-3 only")
    ap.add_argument("--f64-only", nargs="?", const="", metavar="PARENT",
                    help="build permute.cu and sqp_planes.cu and run "
                         "phases 1-2 and the float64 phases only; K1s-A f64 "
                         "beside PARENT's (an unpacked checkout), if given")
    ap.add_argument("--k1s-b-trees", nargs="+", metavar="TREE",
                    help="build sqp_planes.cu and time K1s-B from each "
                         "TREE (an unpacked checkout) beside this tree's, "
                         "phases 1-2 and this one only")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card, smi = phase_device()
    dev = torch.device("cuda")
    if args.k2_only:
        phase_build(("permute",))
        phase_permute(dev)
        print(smi)
        return 0
    if args.k1s_b_trees:
        phase_k1s_b_trees(dev, args.k1s_b_trees)
        print(smi)
        return 0
    if args.f64_only is not None:
        phase_build(("permute", "sqp_planes"))
        phase_k1_f64(dev)
        phase_k1a_f64(dev, args.f64_only or None)
        print(smi)
        return 0
    _, k1_regs, k3_regs, k6_regs, k57_regs, k4_regs = phase_build()
    k2, per_call = phase_permute(dev)
    if (per_call["take_lanes"], per_call["set_lanes"]) != (1, 1):
        raise AssertionError(f"a K2 call ran more than one kernel: {per_call}")
    k1_err, k1_t, k1_plain, k1_b, r6_launches = phase_k1(dev)
    k1d_err, _, k1d_passes = phase_k1_designs(dev)
    k1f_err, k1f_t, k1f_passes, k1f_floor = phase_k1_factor_designs(dev)
    k1r = phase_k1_rank6_designs(dev)
    phase_k1_f64(dev)
    phase_k1a_f64(dev)
    st, info, prob, launches, spec = phase_cold(dev, f"{smi}")
    phase_warm(dev, st, prob)
    phase_compaction(dev)
    phase_plain_solve(dev)
    phase_oracle(st, info, prob)
    del st, info, prob
    torch.cuda.empty_cache()
    _, k_err, k_t, k_b = phase_sync_kernels(dev)
    k6d_err, k6d_t, k6d_dev = phase_k6_designs(dev)
    k57 = phase_k5_k7a_designs(dev)
    sync = phase_sync(dev, f"{smi}", spec)
    d_err, d_t, d_b, k4_launches = phase_dense_kernels(dev)
    k3d_err, k3d_t, k3d_passes, k3d_floor = phase_k3_designs(dev)
    k4d = phase_k4a_designs(dev)
    dense = phase_dense(dev, f"{smi}", spec)
    phase_parity(dev)
    k7b_err, k7b_t, k7b_b, k7b_launches = phase_k7b(dev)
    phase_single(dev, f"{smi}")
    phase_exact_batched(dev, f"{smi}")
    factor = phase_factor(dev, f"{smi}", spec)

    pallas = sync["pallas"]["launches"]
    per_stage_q = sync["lqr_per_stage_q"]["launches"]
    dense_spec = dense["spec"]["launches"]
    dense_sync = dense["sync"]["launches"]
    k1_launches = {"sqp_planes": launches["sqp_planes"],
                   "sqp_planes_rank6": r6_launches["sqp_planes_rank6"],
                   "sqp_planes_factor":
                       factor["spec"]["launches"]["sqp_planes_factor"]}
    kernels = [_k1_entry(k1_launches["sqp_planes"], k1_err["sqp_planes"],
                         k1_t["sqp_planes"], k1_plain["sqp_planes"],
                         k1_b["sqp_planes"], k1_regs, k1d_err, k1d_passes)]
    kernels.append(_k1_rank6_entry(
        k1_launches["sqp_planes_rank6"], k1_err["sqp_planes_rank6"],
        k1_t["sqp_planes_rank6"], k1_plain["sqp_planes_rank6"],
        k1_b["sqp_planes_rank6"], k1_regs, *k1r))
    kernels.append(_k1_factor_entry(
        k1_launches["sqp_planes_factor"], k1_err["sqp_planes_factor"],
        k1_t["sqp_planes_factor"], k1_plain["sqp_planes_factor"],
        k1_b["sqp_planes_factor"], k1_regs, k1f_err, k1f_t, k1f_passes,
        k1f_floor))
    for name, replaces in (("take_lanes", "ops/permute_pallas.py:48"),
                           ("set_lanes", "ops/permute_pallas.py:149")):
        k_call, l_call, k_dev, l_dev, bound = k2[name]
        kernels.append(_entry(name, "permute.cu", replaces, launches[name],
                              0.0, k_call, l_call, bound, l_call,
                              device_ms=k_dev, library_device_ms=l_dev))
    for name, replaces, n in (
            ("sqp_onepass_cand", "ops/sqp_pallas.py:574",
             dense_spec["sqp_onepass_cand"]),
            ("sqp_onepass", "ops/sqp_pallas.py:492",
             dense_sync["sqp_onepass"])):
        kernels.append(_k3_entry(name, replaces, n, d_err[name],
                                 *d_t[name], d_b[name], k3_regs, k3d_err,
                                 k3d_t, k3d_passes, k3d_floor))
    for name, source, replaces, n, err, t, b in (
            ("sqp_twopass_bwd", "sqp_twopass.cu", "ops/sqp_pallas.py:383",
             k4_launches["sqp_twopass_bwd"], d_err, d_t, d_b),
            ("sqp_twopass_fwd", "sqp_twopass.cu", "ops/sqp_pallas.py:465",
             k4_launches["sqp_twopass_fwd"], d_err, d_t, d_b),
            ("linearize", "linearize.cu", "models/srbd_pallas.py:35",
             pallas["linearize"], k_err, k_t, k_b),
            ("riccati_bwd_constq", "riccati.cu", "ops/riccati_pallas.py:100",
             pallas["riccati_bwd_constq"], k_err, k_t, k_b),
            ("riccati_bwd", "riccati.cu", "ops/riccati_pallas.py:56",
             per_stage_q["riccati_bwd"], k_err, k_t, k_b),
            ("riccati_fwd", "riccati.cu", "ops/riccati_pallas.py:142",
             pallas["riccati_fwd"], k_err, k_t, k_b),
            ("merit_alpha", "merit.cu", "models/merit_pallas.py:131",
             pallas["merit_alpha"], k_err, k_t, k_b)):
        extra = (_k6_extra(name, k6_regs, k6d_err, k6d_t, k6d_dev)
                 if name in K6_NAMES else
                 _k5_k7a_extra(name, k57_regs, *k57)
                 if name in ("linearize", "merit_alpha") else
                 _k4a_extra(k4_regs, *k4d)
                 if name == "sqp_twopass_bwd" else {})
        kernels.append(_entry(name, source, replaces, n,
                              max(err[name], extra.pop("design_err", 0.0)),
                              *t[name], b[name], **extra))
    for name, replaces in (("merit", "models/merit_pallas.py:32"),
                           ("merit_nograd", "models/merit_pallas.py:42")):
        kernels.append(_entry(name, "merit.cu", replaces, k7b_launches[name],
                              k7b_err[name], *k7b_t[name], k7b_b[name]))
    print(f"[end] the script ran {time.perf_counter() - t_start:.1f} s, "
          "the kernels' build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
