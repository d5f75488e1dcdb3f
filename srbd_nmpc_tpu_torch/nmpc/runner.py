"""CLI / benchmark runner: the reference's ``main`` + ``controlLoop``
(counterpart of ``srbd_nmpc_tpu/nmpc/runner.py``).

Usage:
    python -m srbd_nmpc_tpu_torch.nmpc.runner [--config mpc_option.yaml]
        [--nrep 100] [--batch 1] [--dtype f32] [--sensitivity euler]
        [--refine 0] [--device cuda]

The CLI and ``run_control_loop`` run on the CUDA card unless asked for the
CPU (``--device cpu``, ``device="cpu"``); without a card the default
raises.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.nmpc import engine
from srbd_nmpc_tpu_torch.parallel import sharded
from srbd_nmpc_tpu_torch.utils.config import MpcOptions, load_mpc_options
from srbd_nmpc_tpu_torch.utils.device import (DeviceLike, device_name,
                                              resolve_device)
from srbd_nmpc_tpu_torch.utils.timing import benchmark


def build_from_options(opts: MpcOptions, dtype=torch.float32,
                       sensitivity: str = "euler", refine: int = 0,
                       device: DeviceLike = None):
    """Map reference YAML options onto engine structures."""
    cfg = engine.NmpcConfig(
        N=opts.horizon,
        sqp_max_iter=opts.sqp_max_loop,
        mu_barrier=opts.mu_barrier,
        theta_barrier=opts.theta_barrier,
        sensitivity=sensitivity,
        refine=refine,
    )
    params = srbd.SRBDParams.create(
        mass=15.0, inertia_diag=opts.lbody, dt=opts.dt_mpc, dtype=dtype,
        device=device)
    weights = engine.NmpcWeights.create(
        Q_diag=opts.Q, R_scalar=opts.R, Qf_diag=opts.Qf, N=opts.horizon,
        dtype=dtype, device=device)
    return params, weights, cfg


def run_control_loop(opts: MpcOptions, batch: int = 1, dtype=torch.float32,
                     sensitivity: str = "euler", refine: int = 0,
                     nrep: Optional[int] = None,
                     device: DeviceLike = None) -> dict:
    """Timed benchmark loop (controlLoop parity): rep 0 is the full cold
    SQP descent; the timed reps re-solve from its converged state."""
    dev = resolve_device(device)
    nrep = opts.n_rep if nrep is None else nrep
    params, weights, cfg = build_from_options(opts, dtype, sensitivity,
                                              refine, dev)
    x0, x_ref = engine.make_benchmark_problem(cfg, dtype, dev)
    state = sharded.broadcast_state(engine.NmpcState.initial(cfg.N, dtype, dev),
                                    batch)
    x0s = x0.expand(batch, srbd.NX).contiguous()

    state_f, infos, summary = sharded.solve_batch(params, weights, cfg, state,
                                                  x0s, x_ref)
    res = benchmark(
        lambda s: sharded.solve_batch(params, weights, cfg, s, x0s, x_ref)[0],
        state_f, reps=nrep, device=dev)

    print(infos.pretty())
    n_conv = int(summary.n_converged)
    out = dict(
        nrep=nrep, batch=batch, horizon=cfg.N, dt=opts.dt_mpc,
        converged=n_conv, avg_ms=res.avg_ms, p50_ms=res.p50_ms,
        p90_ms=res.p90_ms, solves_per_s=batch * 1e3 / res.p50_ms,
        mean_sqp_iters=float(summary.mean_iters), device=device_name(dev),
    )
    print("-----------------------")
    print(f"Device: {out['device']}")
    print(f"Testing repetitions: {nrep}")
    print(f"NMPC horizon: {cfg.N}")
    print(f"NMPC dt: {opts.dt_mpc}")
    print(f"Scenario batch: {batch}  (converged: {n_conv}/{batch})")
    print(f"Average NMPC solution time = {res.avg_ms:.4f}ms  "
          f"[warm-start reps; p50 {res.p50_ms:.4f} p90 {res.p90_ms:.4f}]")
    print(f"Throughput: {out['solves_per_s']:.1f} solves/s")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="SRBD NMPC benchmark (PyTorch)")
    ap.add_argument("--config", default=None,
                    help="reference-format mpc_option.yaml (default: builtin)")
    ap.add_argument("--nrep", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--sensitivity", choices=["euler", "exact"], default="euler")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    opts = load_mpc_options(args.config) if args.config else MpcOptions.default()
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    run_control_loop(opts, batch=args.batch, dtype=dtype,
                     sensitivity=args.sensitivity, refine=args.refine,
                     nrep=args.nrep, device=args.device)


if __name__ == "__main__":
    main()
