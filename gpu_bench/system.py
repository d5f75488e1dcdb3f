"""The system under test: ``srbd_nmpc_tpu_torch``'s batched solve entry.

Builds the program's parameters from a configuration file and hands each
batch to ``srbd_nmpc_tpu_torch.parallel.sharded.solve_batch``. Nothing else
of the program is called, and only what the entry returns is read.
"""

from __future__ import annotations

import dataclasses

import torch

# solver constants of the configuration file -> NmpcConfig fields
_SOLVER_FIELDS = ("theta_max", "theta_min", "eta", "beta_phi", "beta_theta",
                  "beta_alpha", "alpha_min", "reg", "conv_dphi", "conv_theta")


@dataclasses.dataclass
class Answer:
    """What one batch returned: the final iterate and the per-scenario
    diagnostics the benchmark reads."""

    x: torch.Tensor          # [B, N+1, 12]
    u: torch.Tensor          # [B, N, 12]
    alpha: torch.Tensor      # [B]
    status: torch.Tensor     # [B] int32
    sqp_iters: torch.Tensor  # [B] int32
    converged: torch.Tensor  # [B] bool


class System:
    """The program at one configuration on one device."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        from srbd_nmpc_tpu_torch.models import srbd
        from srbd_nmpc_tpu_torch.nmpc import engine
        from srbd_nmpc_tpu_torch.parallel import sharded

        self._engine, self._sharded = engine, sharded
        m, o, s = config["model"], config["mpc"], config["solver"]
        self.N = o["horizon_MPC"]
        self.device, self.dtype = torch.device(device), dtype
        self.params = srbd.SRBDParams.create(
            mass=m["mass"], inertia_diag=o["Lbody"],
            foot_right=m["foot_right"], foot_left=m["foot_left"],
            dt=o["dt_MPC"], mu=m["friction_mu"], lfx=m["foot_lx"],
            lfz=m["foot_lz"], fmax=m["fmax"], fmin=m["fmin"], dtype=dtype,
            device=self.device)
        self.weights = engine.NmpcWeights.create(
            Q_diag=o["Q"], R_scalar=o["R"], Qf_diag=o["Qf"], N=self.N,
            dtype=dtype, device=self.device)
        self.cfg = engine.NmpcConfig(
            N=self.N, sqp_max_iter=o["sqp_max_loop"], mu_barrier=o["mu_b"],
            theta_barrier=o["theta_b"], **{k: s[k] for k in _SOLVER_FIELDS},
            **config["route"])
        self.x_ref = torch.as_tensor(config["problem"]["x_ref"], dtype=dtype,
                                     device=self.device).expand(
            self.N + 1, 12).contiguous()

    def solve(self, x, u, alpha, x0) -> Answer:
        """One batch: the SQP solve of every scenario from the iterate
        (x [B, N+1, 12], u [B, N, 12], alpha [B]) with initial states
        x0 [B, 12], through the program's public entry."""
        state = self._engine.NmpcState(x=x, u=u, alpha=alpha)
        st, info, _ = self._sharded.solve_batch(
            self.params, self.weights, self.cfg, state, x0, self.x_ref)
        return Answer(x=st.x, u=st.u, alpha=st.alpha, status=info.status,
                      sqp_iters=info.sqp_iters, converged=info.converged)
