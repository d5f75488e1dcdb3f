"""Relaxed logarithmic barrier (counterpart of ``srbd_nmpc_tpu/ops/barrier.py``).

For a constraint value ``v`` (feasible when v > 0), weight ``mu`` and
relaxation threshold ``theta``:

    v > theta:   b = -mu log(v),      db = -mu/v,              ddb =  mu/v^2
    v <= theta:  b = mu/2 (((v-2t)/t)^2 - 1) - mu log(t)
                 db = mu (v - 2t)/t^2
                 ddb = mu/t^2

Branchless: the log branch is evaluated at a safe argument (``theta``)
where it is not selected, so no NaN or inf is ever computed.
"""

from __future__ import annotations

from typing import Tuple

import torch


def relaxed_log_barrier(v: torch.Tensor, mu: float, theta: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (b, db, ddb), elementwise over ``v``."""
    mu_t = torch.as_tensor(mu, dtype=v.dtype, device=v.device)
    th = torch.as_tensor(theta, dtype=v.dtype, device=v.device)

    in_log = v > th
    v_safe = torch.where(in_log, v, th)

    b_log = -mu_t * torch.log(v_safe)
    db_log = -mu_t / v_safe
    ddb_log = mu_t / (v_safe * v_safe)

    z = (v - 2.0 * th) / th
    b_quad = 0.5 * mu_t * (z * z - 1.0) - mu_t * torch.log(th)
    db_quad = mu_t * (v - 2.0 * th) / (th * th)
    ddb_quad = (mu_t / (th * th)).expand(v.shape)

    b = torch.where(in_log, b_log, b_quad)
    db = torch.where(in_log, db_log, db_quad)
    ddb = torch.where(in_log, ddb_log, ddb_quad)
    return b, db, ddb
