"""Scenario-batched solve entry point and its batch summary (one device).

Counterpart of ``srbd_nmpc_tpu/parallel/sharded.py:26-66, 149-153``. The
multi-device solvers (``make_sharded_solver``, ``make_shardmap_solver``)
are not ported yet (ROADMAP.md Queue 1, "Multi-device").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.nmpc import engine


@dataclasses.dataclass(frozen=True)
class BatchSummary:
    """Cross-scenario aggregates (0-d tensors on the solve's device)."""

    n_converged: torch.Tensor
    mean_iters: torch.Tensor
    max_theta: torch.Tensor
    max_defect: torch.Tensor
    min_constraint: torch.Tensor


def summarize(infos: engine.NmpcInfo) -> BatchSummary:
    return BatchSummary(
        n_converged=infos.converged.to(torch.int32).sum(),
        mean_iters=infos.sqp_iters.to(torch.float32).mean(),
        max_theta=infos.theta.max(),
        max_defect=infos.max_defect.max(),
        min_constraint=infos.min_constraint.min(),
    )


def solve_batch(
    params: srbd.SRBDParams,
    weights: engine.NmpcWeights,
    cfg: engine.NmpcConfig,
    states: engine.NmpcState,     # leading [B] axis on every leaf
    x0s: torch.Tensor,            # [B, nx]
    x_ref: torch.Tensor,          # [N+1, nx] (shared) or [B, N+1, nx]
) -> Tuple[engine.NmpcState, engine.NmpcInfo, BatchSummary]:
    """Batched NMPC solve on the device the inputs lie on."""
    states_f, infos = engine.solve(params, weights, cfg, states, x0s, x_ref)
    return states_f, infos, summarize(infos)


def broadcast_state(state: engine.NmpcState, batch: int) -> engine.NmpcState:
    """Tile a single-scenario state to a [B]-leading batch (copies)."""
    def tile(a):
        return a.expand((batch,) + tuple(a.shape)).clone()

    return engine.NmpcState(x=tile(state.x), u=tile(state.u),
                            alpha=tile(state.alpha))
