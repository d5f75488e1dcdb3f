"""The one traffic generator: reads a mix from ``traffic/<name>.json``.

A mix says how each batch of the fleet starts:

- ``"start": "cold"``: every scenario from the fixed initial iterate
  ``initial_iterate`` (x, u and alpha as constants).
- ``"start": "warm"``: set-up solves the fleet once cold (from
  ``initial_iterate`` and a draw of its own); every batch then starts
  from that solution shifted ``shift`` stages forward, alpha reset to 1
  (a receding-horizon cycle).

Each batch's initial states are ``x0 + x0_noise_std * N(0, 1)``, drawn
afresh per batch from the seed, where ``x0`` is the configuration's
nominal state (cold) or the set-up solution's state at stage ``shift``
(warm). The draws are made on the device with a ``torch.Generator`` seeded
from ``--seed``, so a seed gives the same batches on every run.

The reference is handed the same draws (``reference_start``). For a warm
mix it starts where the program started: from the program's own set-up
solution at the sampled scenarios, shifted and cast to the reference's
precision, which set-up keeps on the host. That solution is checked in
turn: the reference solves the set-up of the same scenarios cold
(``setup_start``) and the check compares the two (its ``setup_*``
entries), so a wrong set-up cannot pass as the reference's start.
"""

from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        spec = json.load(f)
    if spec.get("start") not in ("cold", "warm"):
        raise ValueError(
            f"traffic {name!r}: unknown start {spec.get('start')!r}")
    return spec


def shift(x, u, steps: int):
    """The trajectories ``steps`` stages forward, the last entries
    repeated; alpha 1."""
    x = torch.cat([x[:, steps:], x[:, -1:].expand(-1, steps, -1)], 1)
    u = torch.cat([u[:, steps:], u[:, -1:].expand(-1, steps, -1)], 1)
    return x, u, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


class Traffic:
    """The batches of one run: ``draw()`` gives a batch's noise, ``start``
    the program's inputs for it."""

    def __init__(self, spec: dict, config: dict, batch: int, seed: int,
                 device, dtype):
        self.spec, self.B = spec, batch
        self.N = config["mpc"]["horizon_MPC"]
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.std = float(spec["x0_noise_std"])
        self.x0_nom = torch.as_tensor(config["problem"]["x0"], dtype=dtype,
                                      device=self.device)
        self.cold = self._cold(batch)
        self.base = None
        self.setup_noise = None
        self.setup_answer = None

    def _cold(self, n: int):
        it = self.spec["initial_iterate"]
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.full((n, self.N + 1, 12), float(it["x"]), **kw),
                torch.full((n, self.N, 12), float(it["u"]), **kw),
                torch.full((n,), float(it["alpha"]), **kw))

    def draw(self) -> torch.Tensor:
        return torch.randn((self.B, 12), generator=self.gen,
                           dtype=self.dtype, device=self.device)

    @property
    def warm(self) -> bool:
        return self.spec["start"] == "warm"

    def setup(self, solve) -> None:
        """For a warm mix: one cold solve of the fleet by ``solve(x, u,
        alpha, x0)``, which returns the program's answer (``x``, ``u``,
        ``status``, ``sqp_iters``); its solution, shifted, is every
        batch's start, and the answer is kept on the host for the
        check."""
        if not self.warm:
            return
        self.setup_noise = self.draw()
        a = solve(*self.cold, self.x0_nom + self.std * self.setup_noise)
        self.base = shift(a.x, a.u, int(self.spec["shift"]))
        self.setup_answer = dict(x=a.x.cpu(), u=a.u.cpu(),
                                 status=a.status.cpu(),
                                 iters=a.sqp_iters.cpu())

    def start(self, noise: torch.Tensor):
        """(x, u, alpha, x0) of the batch with this noise."""
        if self.base is None:
            return (*self.cold, self.x0_nom + self.std * noise)
        x, u, alpha = self.base
        return x, u, alpha, x[:, 0] + self.std * noise

    def setup_answers(self, lanes: torch.Tensor) -> dict:
        """The program's set-up answer at ``lanes`` of the fleet, on their
        device, keyed as the check reads a sample."""
        at = lanes.cpu()
        out = {k: v[at].to(lanes.device)
               for k, v in self.setup_answer.items()}
        return dict(out, lanes=lanes)

    def _cold_start(self, noise: torch.Tensor, dtype):
        """The initial iterate and ``x0 + std * noise`` in ``dtype``."""
        x, u, alpha = (t.to(dtype) for t in self._cold(noise.shape[0]))
        return x, u, alpha, self.x0_nom.to(dtype) + self.std * noise.to(dtype)

    def setup_start(self, lanes: torch.Tensor, dtype):
        """The set-up solve's start of the scenarios at ``lanes``, in
        ``dtype``."""
        return self._cold_start(self.setup_noise[lanes], dtype)

    def reference_start(self, lanes: torch.Tensor, noise: torch.Tensor,
                        dtype):
        """The program's start of the scenarios at ``lanes`` with these
        noise draws, in ``dtype``: cold, the initial iterate; warm, the
        program's set-up solution there, shifted as its batches are."""
        if not self.warm:
            return self._cold_start(noise, dtype)
        s = self.setup_answers(lanes)
        x, u, alpha = shift(s["x"].to(dtype), s["u"].to(dtype),
                            int(self.spec["shift"]))
        return x, u, alpha, x[:, 0] + self.std * noise.to(dtype)
