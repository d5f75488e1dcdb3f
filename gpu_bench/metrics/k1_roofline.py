"""K1's share of its roofline, in %, over the traced batches: the fused
SQP trip's operations for every SQP iteration the solves took, over the
FP32 peak, divided by the device time of K1's kernels (``k1s_*``, its
three launches).

Frozen count of one lane-call of K1's gains body at N=20 (the default
``NmpcConfig``'s trip: linearization, structured Riccati pass, rollout and
merit): 318,892.93 operations, from ``srbd_nmpc_tpu_torch.utils.opcount.
count_sqp_planes`` on 1,024 lanes of ``chip_smoke._k1_inputs(
numpy.random.default_rng(0), 20, 8192, "cpu", False)`` at commit 2a93068
(each + - * / sqrt rsqrt sin cos log of the body counted on a counting
scalar; K1 at B=131072: 0.624 ms at 67 TFLOP/s). Bytes: its inputs read
once and outputs written once, xa, us, xra, dxc, duc, alpha, x0s, dx, du,
dphi and four merit words in float32: 6,984 a lane.

The count stays frozen at the work the inputs need. The split launches
count 329,786.93 on the same inputs, because each member of a team of 16
forms the Cholesky's pivots again; that repetition is the
implementation's, not the problem's, so a share does not credit it.
``k1_f64_roofline``, ``step_mfu`` and ``step_mfu_f64`` read the same
constant for the same reason.
"""

from gpu_bench import roofline

OPS_PER_LANE = 318892.93
BYTES_PER_LANE = 6984


def read(run):
    if run.trace is None:
        return None
    s, _ = run.trace.seconds(lambda name: "k1s_" in name)
    return roofline.share_pct(OPS_PER_LANE, BYTES_PER_LANE,
                              roofline.traced_iterations(run), s)
