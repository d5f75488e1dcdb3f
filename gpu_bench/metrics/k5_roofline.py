"""K5's share of its roofline, in %, over the traced batches: the bytes of
the stage linearization for every SQP iteration the solves took, over the
HBM peak, divided by the device time of K5's two launches
(``k5s_stage_kernel``, ``k5s_dense_kernel``).

Frozen counts of one lane-call at N=20 (float32): bytes 41,920, its inputs
read once (x, next x, u and the reference: 4 x 20 x 12 words) and outputs
written once (A, B and R_eff: 3 x 20 x 144; b, q and r_eff: 3 x 20 x 12;
the merit rows 20 x 8); at B=131072 1.640 ms at 3.35 TB/s. Operations
299,040, from ``srbd_nmpc_tpu_torch.utils.opcount.count_linearize`` on
1,024 lanes of ``chip_smoke._sync_kernel_inputs(numpy.random.
default_rng(0), 8192, "cpu")`` at commit 2a93068 (a bound of 0.585 ms,
below the bytes').
"""

from gpu_bench import roofline

OPS_PER_LANE = 299040.0
BYTES_PER_LANE = 41920


def read(run):
    if run.trace is None:
        return None
    s, _ = run.trace.seconds(
        lambda name: "k5s_stage_kernel" in name or "k5s_dense_kernel" in name)
    return roofline.share_pct(OPS_PER_LANE, BYTES_PER_LANE,
                              roofline.traced_iterations(run), s)
