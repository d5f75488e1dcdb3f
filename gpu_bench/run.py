"""Benchmark of srbd_nmpc_tpu_torch on CUDA cards: one run of one cell.

    python3 gpu_bench/run.py --workload fleet_cold --seed 7 --seconds 30 \
        --trace 0

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
``device`` and, last, ``checks``: each number the check compared beside its
limit, which also close standard error. Exits non-zero, printing no
result, without CUDA cards enough for the cell, and where JAX or the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that must not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "srbd_nmpc_tpu")

sys.path.insert(0, ROOT)

import torch  # noqa: E402


def _finite(v):
    return v if not isinstance(v, float) or math.isfinite(v) else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpu_bench import harness

    spec = harness.benchmark_spec()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    torch.set_num_threads(1)

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), spec=spec,
                           t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out["checks"] = {k: {kk: _finite(vv) for kk, vv in c.items()}
                     for k, c in out.pop("checks").items()}
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
