"""YAML configuration, schema-compatible with the reference
(counterpart of ``srbd_nmpc_tpu/utils/config.py``).

``yaml`` is imported inside ``load_mpc_options`` only, so the built-in
defaults (``MpcOptions.default()``) work where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class MpcOptions:
    """Parsed reference-schema options."""

    Q: List[float]
    Qf: List[float]
    R: float
    dt_mpc: float
    horizon: int
    sqp_max_loop: int
    lbody: List[float]
    mu_barrier: float
    theta_barrier: float
    n_rep: int

    @staticmethod
    def default() -> "MpcOptions":
        """The shipped benchmark config (config/mpc_option.yaml)."""
        return MpcOptions(
            Q=[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 10],
            Qf=[0.5, 0.5, 0.5, 0.01, 0.01, 0.01, 100, 100, 100, 0.0, 0.0, 100.0],
            R=0.0001,
            dt_mpc=0.015,
            horizon=20,
            sqp_max_loop=15,
            lbody=[0.541667, 0.516667, 1.0416667],
            mu_barrier=0.1,
            theta_barrier=5.0,
            n_rep=100,
        )


def load_mpc_options(path: str) -> MpcOptions:
    """Parse a reference-format YAML file; a missing key raises with its
    name."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)

    def get(node, *keys):
        cur = node
        trail = []
        for k in keys:
            trail.append(k)
            if not isinstance(cur, dict) or k not in cur:
                raise KeyError(f"missing config key: {'.'.join(trail)}")
            cur = cur[k]
        return cur

    Q = [float(v) for v in get(cfg, "MPC", "Q")]
    Qf = [float(v) for v in get(cfg, "MPC", "Qf")]
    if len(Q) != 12 or len(Qf) != 12:
        raise ValueError("MPC.Q and MPC.Qf must have 12 entries")
    lbody = [float(v) for v in get(cfg, "Physical", "Lbody")]
    if len(lbody) != 3:
        raise ValueError("Physical.Lbody must have 3 entries")
    return MpcOptions(
        Q=Q,
        Qf=Qf,
        R=float(get(cfg, "MPC", "R")),
        dt_mpc=float(get(cfg, "MPC", "dt_MPC")),
        horizon=int(get(cfg, "MPC", "horizon_MPC")),
        sqp_max_loop=int(get(cfg, "MPC", "sqp_max_loop")),
        lbody=lbody,
        mu_barrier=float(get(cfg, "mu_b")),
        theta_barrier=float(get(cfg, "theta_b")),
        n_rep=int(get(cfg, "N_rep")),
    )
