"""The check of a warm mix (``traffic/warm.json``), on the CPU at a small
batch: the reference starts where the program started, from the program's
own set-up solution at the sampled scenarios, shifted and cast; a cold
mix's starts are as they always were; and the set-up itself is compared
(the ``setup_*`` entries), so a wrong set-up is caught even where every
batch solves honestly from it."""

import dataclasses

import torch

from gpu_bench import check, harness, traffic
from gpu_bench.system import Answer

B = 96
SEED = 2 ** 31 + 113
CFG = harness.load_config("srbd_n20_fleet")
# the warm mix in a cell of the default route
WARM_SPEC = harness.benchmark_spec()
WARM_SPEC["workloads"].append(dict(
    name="fleet_warm", config="srbd_n20_fleet", traffic="warm", chips=1,
    why="the receding-horizon cycle of the default route"))


def _drawn_setup(x, u, alpha, x0):
    """A set-up answer drawn from a seed, as the program could return it."""
    gen = torch.Generator().manual_seed(5)
    n = x.shape[0]
    return Answer(
        x=torch.randn(x.shape, generator=gen, dtype=x.dtype),
        u=torch.randn(u.shape, generator=gen, dtype=u.dtype),
        alpha=alpha, status=torch.randint(4, (n,), generator=gen,
                                          dtype=torch.int32),
        sqp_iters=torch.randint(16, (n,), generator=gen, dtype=torch.int32),
        converged=torch.ones(n, dtype=torch.bool))


def _traffic(mix, solve=_drawn_setup):
    tr = traffic.Traffic(traffic.load(mix), CFG, B, SEED, "cpu",
                         torch.float32)
    tr.setup(solve)
    return tr


LANES = torch.tensor([5, 0, 95, 5, 17, 63])


def test_warm_reference_starts_from_the_programs_setup():
    tr = _traffic("warm")
    want = _drawn_setup(*tr.cold, None)
    noise = tr.draw()
    x, u, alpha, x0 = tr.reference_start(LANES, noise[LANES], torch.float64)
    sx, su = want.x[LANES], want.u[LANES]
    assert x.dtype == u.dtype == alpha.dtype == x0.dtype == torch.float64
    assert torch.equal(x, torch.cat([sx[:, 1:], sx[:, -1:]], 1).double())
    assert torch.equal(u, torch.cat([su[:, 1:], su[:, -1:]], 1).double())
    assert torch.equal(alpha, torch.ones(len(LANES), dtype=torch.float64))
    assert torch.equal(x0, x[:, 0] + 0.01 * noise[LANES].double())
    # the program's own batch start at the same lanes, cast
    px, pu, palpha, px0 = tr.start(noise)
    assert torch.equal(px[LANES].double(), x)
    assert torch.equal(pu[LANES].double(), u)
    assert torch.equal(palpha[LANES].double(), alpha)
    torch.testing.assert_close(px0[LANES].double(), x0, rtol=0, atol=1e-6)
    # and the set-up answer it came from, on the check's side
    got = tr.setup_answers(LANES)
    assert torch.equal(got["status"], want.status[LANES])
    assert torch.equal(got["iters"], want.sqp_iters[LANES])
    assert torch.equal(got["lanes"], LANES)


def test_cold_reference_start_is_as_before():
    """A cold mix solves nothing at set-up, and its reference start is the
    initial iterate and ``x0 + std * noise`` worked out in the reference's
    precision, as before warm mixes were checked from the program's
    set-up."""
    def never(*_):
        raise AssertionError("a cold mix solves nothing at set-up")

    tr = _traffic("cold", solve=never)
    noise = tr.draw()[LANES]
    x, u, alpha, x0 = tr.reference_start(LANES, noise, torch.float64)
    n, f64 = len(LANES), torch.float64
    assert torch.equal(x, torch.zeros(n, 21, 12, dtype=f64))
    assert torch.equal(u, torch.full((n, 20, 12), 100.0, dtype=f64))
    assert torch.equal(alpha, torch.ones(n, dtype=f64))
    x0_nom = torch.tensor(CFG["problem"]["x0"], dtype=torch.float32)
    assert torch.equal(x0, x0_nom.to(f64) + 0.01 * noise.to(f64))
    assert not tr.warm and tr.setup_answer is None


def _reference_program(cfg):
    """The reference in float64 in the program's place: its answers are
    the reference's own."""
    ref = check.reference(cfg)
    P = ref.problem(cfg, torch.float64, "cpu")

    def solve(x, u, alpha, x0):
        xs, us, st, it, cv = ref.solve(P, x, u, alpha, x0)
        return Answer(x=xs, u=us, alpha=alpha, status=st, sqp_iters=it,
                      converged=cv)
    return solve


def test_compare_adds_setup_entries_for_a_warm_mix_only():
    solve = _reference_program(CFG)
    n = 8
    lanes = torch.tensor([0, 3, 3, 7])
    for mix in ("cold", "warm"):
        tr = traffic.Traffic(traffic.load(mix), CFG, n, SEED, "cpu",
                             torch.float64)
        tr.setup(solve)
        noise = tr.draw()
        a = solve(*tr.start(noise))
        sample = dict(lanes=lanes, noise=noise[lanes], x=a.x[lanes],
                      u=a.u[lanes], status=a.status[lanes],
                      iters=a.sqp_iters[lanes])
        out = check.compare(CFG, tr, sample, "cpu")
        keys = ["mismatch_pct", "u_gap", "x_gap"]
        if mix == "warm":
            keys += ["setup_mismatch_pct", "setup_u_gap", "setup_x_gap"]
        assert list(out) == keys + ["lost_batches"]
        assert check.correct(out), out
        assert all(out[k]["limit"] == CFG["limits"][k.replace("setup_", "")]
                   for k in keys)


def _setup_altered(solve):
    """The program's set-up u altered on every other scenario at a stage
    that the shift keeps; the batches then solve honestly from it."""
    calls = []

    def run(x, u, alpha, x0):
        a = solve(x, u, alpha, x0)
        if not calls:
            calls.append(1)
            u_bad = a.u.clone()
            u_bad[::2, 5, 2] += 1.0
            return dataclasses.replace(a, u=u_bad)
        return a
    return run


def test_setup_fault_is_not_correct_through_the_setup_entries():
    out = harness.run_cell("fleet_warm", SEED, 0.0, False, device="cpu",
                           dtype=torch.float64, batch=B, keep=B,
                           spec=WARM_SPEC, wrap_solve=_setup_altered)
    c = out["checks"]
    assert not out["correct"], c
    # the batches started where the reference did, so only the set-up fails
    for k in ("mismatch_pct", "u_gap", "x_gap"):
        assert c[k]["value"] <= c[k]["limit"], c
    assert c["setup_u_gap"]["value"] > c["setup_u_gap"]["limit"], c
