"""The whole solve's share of the card's FP64 peak, in %, over the traced
batches of a float64 cell: ``step_mfu``'s count (one lane-call of K1's
fused trip, ``k1_roofline.OPS_PER_LANE``, for every SQP iteration the
solves took) over the FP64 peak outside the tensor cores
(``k1_f64_roofline.PEAK_FP64``) times the traced batches' wall time.
``step_mfu`` reads the same count against the FP32 peak."""

from gpu_bench import roofline
from gpu_bench.metrics import k1_f64_roofline, k1_roofline


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    ops = k1_roofline.OPS_PER_LANE * roofline.traced_iterations(run)
    return 100.0 * ops / (k1_f64_roofline.PEAK_FP64 * t.window_s)
