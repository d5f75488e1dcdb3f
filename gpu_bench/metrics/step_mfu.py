"""The whole solve's share of the card's FP32 peak, in %, over the traced
batches: the operations of every SQP iteration the solves took, counted as
one lane-call of K1's fused trip each (``k1_roofline.OPS_PER_LANE``, the
least the port's kernels count for one iteration's linearization, QP and
merit, whatever route runs it), over the peak times the traced batches'
wall time. It bounds every kernel's share: a kernel taken off the path
leaves its own share silent, and this one still moves."""

from gpu_bench import roofline
from gpu_bench.metrics import k1_roofline


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    ops = k1_roofline.OPS_PER_LANE * roofline.traced_iterations(run)
    return 100.0 * ops / (roofline.PEAK_FP32 * t.window_s)
