"""Operation counts of the port's CUDA kernels (``utils/opcount.py``): each
kernel source, built as host C++ with the counting scalar, counts its own
arithmetic on the lanes and branches of its inputs. Checked against hand
counts of the two rollouts, against the barrier branch each constraint
takes, for the lane sampling of every kernel's count, and against the
counts of the one-thread bodies that the launches replaced, each gap
named."""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from srbd_nmpc_tpu_torch.models import srbd
from srbd_nmpc_tpu_torch.ops import sqp_kernel
from srbd_nmpc_tpu_torch.utils import opcount

torch.set_num_threads(1)
F64 = torch.float64
N = 4

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler")


def _rand(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape), dtype=F64)


@pytest.mark.parametrize("kernel", ["sqp_twopass_fwd", "riccati_fwd"])
def test_rollout_counts_match_hand_count(kernel):
    """K4b per lane and stage: du = K dx + kv and dx' = Acl dx + bcl (24
    operations a row, 12 rows each), the two dphi dot products (23 each)
    and the running sum (1 at the first stage, 2 after), then the terminal
    dot product and the last add: 624 N + 23. K6c per lane and stage:
    u = K x + k (24 a row) and x' = A x + B u + b (48 a row): 864 N."""
    rng = np.random.default_rng(0)
    B = 5
    if kernel == "sqp_twopass_fwd":
        ops = opcount.count_sqp_twopass_fwd(
            _rand(rng, N, 12, 12, B), _rand(rng, N, 12, 12, B),
            *(_rand(rng, N, 12, B) for _ in range(4)), _rand(rng, 12, B),
            _rand(rng, 12, B))
        assert ops == (624 * N + 23) * B
    else:
        ops = opcount.count_riccati_fwd(
            _rand(rng, N, 12, 12, B), _rand(rng, N, 12, 12, B),
            _rand(rng, N, 12, B), _rand(rng, N, 12, 12, B),
            _rand(rng, N, 12, B), _rand(rng, 12, B))
        assert ops == 864 * N * B


def test_merit_count_follows_the_barrier_branch():
    """K7a evaluates the barrier's value on one branch per constraint: 2
    operations above theta (mu log), 9 at or below it (the quadratic), so
    moving theta changes the count by 7 for each (stage, row, lane) whose
    constraint changes side, and by nothing else."""
    from srbd_nmpc_tpu_torch.nmpc.runner import build_from_options
    from srbd_nmpc_tpu_torch.utils.config import MpcOptions

    params, weights, cfg = build_from_options(MpcOptions.default(),
                                              device="cpu")
    rng = np.random.default_rng(1)
    B = 6
    x = torch.as_tensor(rng.normal(size=(N + 1, 12, B)) * 0.1,
                        dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(N, 12, B)) * 40 + 60,
                        dtype=torch.float32)
    du = torch.as_tensor(rng.normal(size=(N, 12, B)) * 5, dtype=torch.float32)
    alpha = torch.as_tensor(0.2 + 0.6 * rng.random(B), dtype=torch.float32)
    Ac, bc = srbd.constraint_matrix(params)
    args = (params, weights.Q, weights.Qf, weights.R, Ac, bc, x, u,
            torch.zeros_like(x), torch.zeros_like(x), du, alpha)
    # the constraint values as the counting build forms them (f64 on the
    # float32 inputs, each row summed left to right)
    uc = (u.double() + alpha.double() * du.double()).numpy()
    A64, b64 = Ac.double().numpy(), bc.double().numpy()
    con = np.zeros((N, 24, B))
    for r in range(24):
        acc = A64[r, 0] * uc[:, 0]
        for k in range(1, 12):
            acc = acc + A64[r, k] * uc[:, k]
        con[:, r] = acc + b64[r]
    lo, hi = np.quantile(con, 0.3), np.quantile(con, 0.7)
    flipped = int(((con > lo) & (con <= hi)).sum())
    assert flipped > 0
    ops_lo = opcount.count_merit_alpha(*args, cfg.mu_barrier, float(lo))
    ops_hi = opcount.count_merit_alpha(*args, cfg.mu_barrier, float(hi))
    assert ops_hi - ops_lo == 7 * flipped


def _lane(t, B):
    """``t`` with its lane axis (last, of size 1) repeated ``B`` times."""
    if isinstance(t, tuple):
        return tuple(_lane(e, B) for e in t)
    if isinstance(t, torch.Tensor) and t.dim() and t.shape[-1] == 1:
        return t.expand(t.shape[:-1] + (B,)).contiguous()
    return t


def _count_args(kernel):
    """(count function, arguments at one lane, keyword arguments)."""
    rng = np.random.default_rng(2)
    if kernel.startswith("sqp_planes"):
        args, reg = smoke._k1_inputs(rng, smoke.N_MAIN, 1, "cpu", False)
        body = {"sqp_planes_rank6": dict(rank6=True),
                "sqp_planes_factor": dict(factor=True)}.get(kernel, {})
        return opcount.count_sqp_planes, args, dict(reg=reg, **body)
    if kernel.startswith("sqp_"):
        cand, one, bwd, reg = smoke._k3_args(rng, 1, "cpu")
        fwd = (*sqp_kernel.sqp_qp_backward_ref(*bwd, reg=reg)[:7], one[9])
        return {"sqp_onepass_cand": (opcount.count_sqp_onepass_cand, cand,
                                     dict(reg=reg)),
                "sqp_onepass": (opcount.count_sqp_onepass, one, dict(reg=reg)),
                "sqp_twopass_bwd": (opcount.count_sqp_twopass_bwd, bwd,
                                    dict(reg=reg)),
                "sqp_twopass_fwd": (opcount.count_sqp_twopass_fwd, fwd, {}),
                }[kernel]
    lin, L, (K, k), mer = smoke._sync_kernel_inputs(rng, 1, "cpu")
    bwd = (L["A"], L["B"], L["b"])
    return {"linearize": (opcount.count_linearize, lin, {}),
            "riccati_bwd_constq": (opcount.count_riccati_bwd,
                                   (*bwd, L["Qc"], L["R"], L["q"], L["r"]),
                                   dict(reg=L["reg"])),
            "riccati_bwd": (opcount.count_riccati_bwd,
                            (*bwd, L["Qs"], L["R"], L["q"], L["r"]),
                            dict(reg=L["reg"])),
            "riccati_fwd": (opcount.count_riccati_fwd,
                            (*bwd, K, k, L["x0"]), {}),
            "merit_alpha": (opcount.count_merit_alpha, mer, {}),
            "merit": (opcount.count_merit, mer[:9] + mer[12:],
                      dict(with_grad=True)),
            "merit_nograd": (opcount.count_merit, mer[:9] + mer[12:],
                             dict(with_grad=False))}[kernel]


# One lane-call's operations on _count_args(kernel) (N = 20) by the
# one-thread body that the launches replaced, counted before it was
# retired. The launches count ONE_THREAD_OPS + PIVOTS (the team kernels) +
# REST. PIVOTS: a team of 16 (the card's, opcount.TEAM) forms the 12 pivots
# of its Cholesky in every member (team.cuh's team_cholesky: 34 operations a
# stage and member), where one thread formed them once.
ONE_THREAD_OPS = {
    "sqp_planes": 318844,
    "sqp_planes_rank6": 381044,
    "sqp_planes_factor": 284284,
    "sqp_onepass_cand": 342870,
    "sqp_onepass": 341897,
    "sqp_twopass_bwd": 770673,
    "linearize": 299040,
    "riccati_bwd_constq": 491560,
    "riccati_bwd": 491560,
    "merit_alpha": 53356,
}
PIVOT_OPS = 34
TEAM_KERNELS = ("sqp_planes", "sqp_planes_factor", "sqp_onepass_cand",
                "sqp_onepass", "sqp_twopass_bwd", "riccati_bwd_constq",
                "riccati_bwd")
REST = {
    # 35 N - 6 (measured at N = 5 and 20), not attributed to one line
    "sqp_planes": 694,
    # the rank-6 team form (its 6x6 factors one member's each, so no pivots
    # repeated) orders its stage's work in its own steps
    "sqp_planes_rank6": -3206,
    # the gains body's 694, and L's diagonal re-formed from its last update
    # when it is parked (k1s::park_word: 34 N)
    "sqp_planes_factor": 1374,
    # K3b's 701, and the candidate x_{k+1} = xa + alpha dxc formed again in
    # the plane pass's thread of stage k + 1 (24 N)
    "sqp_onepass_cand": 1181,
    "sqp_onepass": 701,
    # K5's two launches (241,439 here), the terminal-and-merit pass (392) and
    # K6a's team pass (498,880 with its pivots) with Acl and bcl (24
    # operations an entry: 74,880), against one thread's own stage order
    "sqp_twopass_bwd": 34718,
    # each product Ac(r, j) ddb(r) formed once for six rows of R_eff
    # (-2,880 N), the lever arms formed again for B (+6 N)
    "linearize": -57480,
    # P symmetrized by its 78 entry pairs (-144 N)
    "riccati_bwd_constq": -2880,
    "riccati_bwd": -2880,
    # the candidate x_{g+1} formed in the threads of stage g and g + 1, and
    # x_N again in the terminal row (24 N + 24 = 504), against 5 fewer
    # elsewhere
    "merit_alpha": 499,
}


@pytest.mark.parametrize("kernel", [
    "sqp_planes", "sqp_planes_rank6", "sqp_planes_factor",
    "sqp_onepass_cand", "sqp_onepass", "sqp_twopass_bwd",
    "sqp_twopass_fwd", "linearize", "riccati_bwd_constq", "riccati_bwd",
    "riccati_fwd", "merit_alpha", "merit", "merit_nograd"])
def test_sampled_count_scales_to_the_batch(kernel):
    """On a batch of 8 copies of one scenario, counting 3 sampled lanes
    and counting every lane both give 8 times the one-lane count."""
    fn, args, kw = _count_args(kernel)
    one = fn(*args, **kw)
    wide = _lane(args, 8)
    assert one > 0
    assert fn(*wide, **kw, lanes=3) == fn(*wide, **kw) == 8 * one


def test_k7b_gradients_count_the_gradient_rows():
    """K7b with gradients does the variant without them plus, per stage and
    lane, the 12 rows of Ac' db + R u (24 products, 23 sums and one add
    each: 576) and the barrier's derivative of each of the 24 rows (1
    operation above theta, -mu / con; 5 at or below it)."""
    rng = np.random.default_rng(3)
    _, _, _, mer = smoke._sync_kernel_inputs(rng, 1, "cpu")
    args = mer[:9] + mer[12:]
    theta_b = mer[13]
    grad = opcount.count_merit(*args, with_grad=True)
    nograd = opcount.count_merit(*args, with_grad=False)
    Ac, bc, u = (t.double().numpy() for t in (mer[4], mer[5], mer[7]))
    con = np.einsum("gi,nib->ngb", Ac, u) + bc[None, :, None]
    above = int((con > theta_b).sum())
    assert grad - nograd == (576 * smoke.N_MAIN + above
                             + 5 * (con.size - above))


def test_k1_factor_count_trades_the_back_substitution():
    """K1's factor body drops the stage's 13-column back substitution (row
    i: 13 scalings and 13 (i) multiply-subtracts, 1872 operations over the
    12 rows), adds a one-column one to each rollout stage (144) and
    re-forms L's diagonal from its last update when it parks it (34); the
    rest is the gains body's: -1694 per stage and lane. The rank-6 body
    counts differently from both."""
    fn, args, kw = _count_args("sqp_planes")
    gains = fn(*args, **kw)
    factor = fn(*args, **kw, factor=True)
    assert factor - gains == (-1728 + 34) * smoke.N_MAIN
    assert fn(*args, **kw, rank6=True) not in (gains, factor)


@pytest.mark.parametrize("kernel", list(ONE_THREAD_OPS))
def test_split_count_matches_the_one_thread_count(kernel):
    """Each kernel's launches count the one-thread body's operations but for
    the named gaps (PIVOTS and REST above), and a team kernel's gap scales
    with the team width as its pivots do."""
    fn, args, kw = _count_args(kernel)
    team = kernel in TEAM_KERNELS
    pivots = 15 * PIVOT_OPS * smoke.N_MAIN if team else 0
    assert fn(*args, **kw) == ONE_THREAD_OPS[kernel] + pivots + REST[kernel]
    if team:
        card, opcount.TEAM = opcount.TEAM, 8
        try:
            narrow = fn(*args, **kw)
        finally:
            opcount.TEAM = card
        assert ONE_THREAD_OPS[kernel] + REST[kernel] + 7 * PIVOT_OPS * \
            smoke.N_MAIN == narrow
