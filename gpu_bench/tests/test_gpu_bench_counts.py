"""What a run counts: solves at the iteration cap or the step-length floor
are answers (attempted, unconverged), NaN answers are failures; and the
frozen kernel counts reproduce their recorded bounds."""

import math

import torch

from gpu_bench import harness, roofline
from gpu_bench.metrics import (k1_roofline, k5_roofline, k6a_roofline,
                               sqp_iters, unconverged_pct)
from gpu_bench.system import Answer


def _answer(status, iters, nan_lane=None):
    S = len(status)
    x = torch.zeros(S, 21, 12)
    u = torch.ones(S, 20, 12)
    if nan_lane is not None:
        u[nan_lane, 3, 4] = math.nan
    st = torch.tensor(status, dtype=torch.int32)
    return Answer(x=x, u=u, alpha=torch.ones(S), status=st,
                  sqp_iters=torch.tensor(iters, dtype=torch.int32),
                  converged=st == 0)


def test_cap_and_floor_are_answers_nan_is_a_failure():
    # SUCCESS, MAX_ITER_REACHED, MIN_STEP_LENGTH_REACHED, NAN_DETECTED,
    # and a SUCCESS whose u holds a NaN
    ans = _answer([0, 1, 2, 3, 0], [9, 15, 15, 4, 10], nan_lane=4)
    conv, unconv, failed, iters = harness._counters(ans).tolist()
    assert (conv, unconv, failed, iters) == (2, 2, 2, 53)
    run = harness.Run(config={}, batches=[dict(n=5, conv=conv,
                                               unconv=unconv,
                                               failed=failed, iters=iters,
                                               traced=False)])
    assert unconverged_pct.read(run) == 40.0
    assert sqp_iters.read(run) == 53 / 5


def test_frozen_counts_reproduce_their_bounds():
    lanes = 131072
    ms = {m: 1e3 * roofline.bound_s(m.OPS_PER_LANE * lanes,
                                    m.BYTES_PER_LANE * lanes)
          for m in (k1_roofline, k6a_roofline, k5_roofline)}
    # PERF.md section 6's bounds at B=131072: K1 by operations, K6a and K5
    # by bytes
    assert round(ms[k1_roofline], 3) == 0.624
    assert round(ms[k6a_roofline], 3) == 1.748
    assert round(ms[k5_roofline], 3) == 1.640
