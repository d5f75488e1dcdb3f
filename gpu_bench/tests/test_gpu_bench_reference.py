"""The benchmark's plain reference against the port's routes, in float64
on the CPU at a small batch: same statuses and SQP iterations, the same
iterates to rounding."""

import pytest
import torch

from gpu_bench import harness
from gpu_bench.reference import srbd_sqp as ref
from gpu_bench.system import System

ROUTES = {"xla": {"qp_kernel": "xla", "speculative": False},
          "fused_speculative": {},
          "pallas": {"qp_kernel": "pallas", "speculative": False}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reference_matches_port_route(route):
    cfg = dict(harness.load_config("srbd_n20_fleet"), route=ROUTES[route])
    dt, S, N = torch.float64, 32, cfg["mpc"]["horizon_MPC"]
    gen = torch.Generator().manual_seed(11)
    x0 = (torch.tensor(cfg["problem"]["x0"], dtype=dt)
          + 0.01 * torch.randn(S, 12, generator=gen, dtype=dt))
    x = torch.zeros(S, N + 1, 12, dtype=dt)
    u = torch.full((S, N, 12), 100.0, dtype=dt)
    alpha = torch.ones(S, dtype=dt)
    got = System(cfg, "cpu", dt).solve(x, u, alpha, x0)
    xr, ur, st, it, conv = ref.solve(ref.problem(cfg, dt, "cpu"), x, u,
                                     alpha, x0)
    assert torch.equal(st, got.status)
    assert torch.equal(it, got.sqp_iters)
    assert torch.equal(conv, got.converged)
    assert int(conv.sum()) >= S - 3
    torch.testing.assert_close(got.u, ur, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(got.x, xr, rtol=1e-9, atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                      -3.0 - 2 ** -9], dtype=torch.float32)
    r = ref._round_tf32(t)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                          -3.0 - 2 ** -9]
