"""The check that decides ``correct``: the program's answers for a sample
of the window's scenarios against the plain reference's.

The reference (``reference/<config["reference"]>.py``) solves the sampled
scenarios from the same starts in float64, full precision, once the window
has closed. For a warm mix those starts are the program's own set-up
solution at the sampled scenarios, shifted as its batches are
(``traffic.Traffic.reference_start``). Three numbers are compared, each
with its limit from the configuration's ``limits``:

- ``mismatch_pct``: the share of sampled scenarios whose status or SQP
  iteration count differs from the reference's (an iteration-cap or NaN
  answer counts like any other: it has to be the reference's too);
- ``u_gap`` and ``x_gap``: over the scenarios that both sides solved to
  SUCCESS in the same number of iterations, the widest relative gap of
  the forces u (and states x) to the reference's: per scenario the largest
  |program - reference| over |reference|, the denominator floored at 1 % of
  that scenario's largest |reference| (``parity_metric`` of the port's
  ``utils/metrics.py``, per scenario).

For a warm mix the same three are read once more of the set-up solve, as
``setup_mismatch_pct``, ``setup_u_gap`` and ``setup_x_gap`` under the same
limits: the program's set-up answer at the sampled scenarios against the
reference's cold solve of their set-up. A cold mix has no such entries.

A batch that raised lost its answers: ``lost_batches`` has the limit 0.
"""

from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

# scenarios the reference solves at once
BLOCK = 16384
NAMES = ("mismatch_pct", "u_gap", "x_gap")


def reference(config: dict):
    return importlib.import_module(
        f"gpu_bench.reference.{config['reference']}")


def gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-scenario worst relative gap, floored at 1 % of the scenario's
    largest |ref|: [S, ...] -> [S]."""
    got, ref = got.flatten(1).double(), ref.flatten(1).double()
    floor = 0.01 * ref.abs().amax(1, keepdim=True) + 1e-30
    return ((got - ref).abs() / torch.maximum(ref.abs(), floor)).amax(1)


def reference_answers(config: dict, tr, sample: dict, device):
    """The reference's (x, u, status, iters) for the sampled scenarios,
    in float64 at full precision, solved in blocks of ``BLOCK``; and for a
    warm mix its answers to their set-up solve (else None)."""
    ref = reference(config)
    P = ref.problem(config, torch.float64, device)
    out, setup = [], []
    with ref.full_precision():
        S = sample["lanes"].shape[0]
        for lo in range(0, S, BLOCK):
            sl = slice(lo, min(S, lo + BLOCK))
            lanes = sample["lanes"][sl]
            if tr.warm:
                setup.append(ref.solve(P, *tr.setup_start(
                    lanes, torch.float64))[:4])
            start = tr.reference_start(lanes, sample["noise"][sl],
                                       torch.float64)
            out.append(ref.solve(P, *start)[:4])

    def cat(parts):
        return [torch.cat(t) for t in zip(*parts)] if parts else None
    return cat(out), cat(setup)


def control(config: dict, device):
    """The control: the reference in the program's place, in float32 with
    TF32 products (the precision below the configuration's float32), as a
    ``wrap_solve`` of ``harness.run_cell``; it solves each batch in blocks
    of ``BLOCK``."""
    from gpu_bench.system import Answer

    ref = reference(config)
    P = ref.problem(config, torch.float32, device, tf32=True)

    def wrap(_program_solve):
        def solve(x, u, alpha, x0):
            parts = [ref.solve(P, *(t[lo:lo + BLOCK] for t in
                                    (x, u, alpha, x0)))
                     for lo in range(0, x.shape[0], BLOCK)]
            xs, us, st, it, cv = (torch.cat(t) for t in zip(*parts))
            return Answer(x=xs, u=us, alpha=alpha, status=st, sqp_iters=it,
                          converged=cv)
        return solve
    return wrap


def readings(sample: Optional[dict], answers) -> dict:
    """The three compared numbers of the program's sample against the
    reference's answers for it."""
    if sample is None or sample["lanes"].shape[0] == 0:
        return dict.fromkeys(NAMES, math.inf)
    x_r, u_r, st_r, it_r = answers
    same = (sample["status"] == st_r) & (sample["iters"] == it_r)
    both = same & (st_r == 0)
    out = dict(mismatch_pct=100.0 * float((~same).double().mean()))
    if not bool(both.any()):
        return dict(out, u_gap=math.inf, x_gap=math.inf)
    for key, got, want in (("u_gap", sample["u"], u_r),
                           ("x_gap", sample["x"], x_r)):
        g = gap(got[both], want[both])
        out[key] = float(torch.nan_to_num(g, nan=math.inf).max())
    return out


def compare(config: dict, tr, sample: Optional[dict], device,
            lost: int = 0) -> dict:
    """Readings beside their limits: {name: {"value", "limit"}}."""
    answers, setup = ((None, None) if sample is None
                      else reference_answers(config, tr, sample, device))
    limits = config["limits"]
    out = {k: dict(value=v, limit=limits[k])
           for k, v in readings(sample, answers).items()}
    if tr.warm:
        mine = None if sample is None else tr.setup_answers(sample["lanes"])
        out.update({f"setup_{k}": dict(value=v, limit=limits[k])
                    for k, v in readings(mine, setup).items()})
    out["lost_batches"] = dict(value=lost, limit=0)
    return out


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
