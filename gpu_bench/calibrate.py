"""Readings for the check's limits, on the card, in one process.

    python3 gpu_bench/calibrate.py --workload fleet_cold --seeds 12 \
        --control-seeds 3 --seconds 4

Runs the cell's window of ``--seconds`` on each of ``--seeds`` seeds (the
program's readings: the lower ends of the limits) and, on each of
``--control-seeds`` further seeds, one batch of the control in the
program's place (``check.control``: the reference in float32 with TF32
products; the upper ends), each checked as a run checks its window, and
prints one JSON line per run and a summary of every compared number (a
warm mix's ``setup_*`` entries too). The limits in the
configuration file are set from these readings (PERF.md section 2).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from gpu_bench import check, harness  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    cfg = harness.cell(args.workload)["config"]
    rows, names = [], []
    seeds = [args.first_seed + 7919 * i
             for i in range(args.seeds + args.control_seeds)]
    for i, seed in enumerate(seeds):
        ctrl = i >= args.seeds
        t = time.perf_counter()
        kw = (dict(wrap_solve=check.control(cfg, "cuda"),
                   keep=harness.SAMPLE, warmup=False) if ctrl else {})
        out = harness.run_cell(args.workload, seed, 0.0 if ctrl
                               else args.seconds, False, **kw)
        row = dict(kind="control" if ctrl else "program", seed=seed,
                   seconds=time.perf_counter() - t, run=out["run"],
                   failed=out["failed"], attempted=out["attempted"],
                   **{k: c["value"] for k, c in out["checks"].items()})
        rows.append(row)
        names = names or [k for k in out["checks"] if k != "lost_batches"]
        print(json.dumps(row), flush=True)
    summary = {}
    for kind in ("program", "control"):
        sel = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: dict(min=min(r[k] for r in sel),
                                 max=max(r[k] for r in sel))
                         for k in names} if sel else None
    print(json.dumps(dict(workload=args.workload, summary=summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
