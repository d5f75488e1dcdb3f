"""K1's share of its roofline in its float64 form, in %, over the traced
batches: the fused SQP trip's operations for every SQP iteration the
solves took, over the card's FP64 peak outside the tensor cores, or its
bytes over the HBM peak, whichever bound is larger, divided by the device
time of K1's kernels (``k1s_*``, its three launches).

The same frozen count of one lane-call of K1's gains body at N=20 as
``k1_roofline`` (318,892.93 operations; the body's arithmetic does not
change with its scalar type), over 34 TFLOP/s, the FP64 peak of one H100
SXM outside the tensor cores (NVIDIA's data sheet, half its FP32 peak):
K1 at B=131072 1.229 ms. Bytes: ``k1_roofline``'s 6,984 a lane in float64,
13,968.
"""

from gpu_bench import roofline
from gpu_bench.metrics import k1_roofline

PEAK_FP64 = 34e12       # FLOP/s
OPS_PER_LANE = k1_roofline.OPS_PER_LANE
BYTES_PER_LANE = 2 * k1_roofline.BYTES_PER_LANE


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take in float64."""
    return max(ops / PEAK_FP64, nbytes / roofline.PEAK_BYTES)


def read(run):
    if run.trace is None:
        return None
    s, _ = run.trace.seconds(lambda name: "k1s_" in name)
    lanes = roofline.traced_iterations(run)
    if s <= 0 or lanes <= 0:
        return None
    return 100.0 * bound_s(OPS_PER_LANE * lanes, BYTES_PER_LANE * lanes) / s
