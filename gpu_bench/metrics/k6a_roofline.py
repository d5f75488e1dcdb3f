"""K6a's share of its roofline, in %, over the traced batches: the bytes of
the backward Riccati pass for every SQP iteration the solves took, over the
HBM peak, divided by the device time of K6a's kernel
(``riccati_team_kernel<true>``).

Frozen counts of one lane-call at N=20 (float32): bytes 44,688, its inputs
read once and outputs written once: A and B (2 x 20 x 144 words), b and r
(2 x 20 x 12), q (21 x 12), R's lower triangle (20 x 78; the kernel reads
no more of it), K (20 x 144) and k (20 x 12); at B=131072 1.748 ms at
3.35 TB/s. Operations 491,560, from ``srbd_nmpc_tpu_torch.utils.opcount.
count_riccati_bwd`` on 1,024 lanes of ``chip_smoke._sync_kernel_inputs(
numpy.random.default_rng(0), 8192, "cpu")`` at commit 2a93068 (a bound of
0.962 ms, below the bytes').
"""

from gpu_bench import roofline

OPS_PER_LANE = 491560.0
BYTES_PER_LANE = 44688


def read(run):
    if run.trace is None:
        return None
    s, _ = run.trace.seconds(lambda name: "riccati_team_kernel<true>" in name)
    return roofline.share_pct(OPS_PER_LANE, BYTES_PER_LANE,
                              roofline.traced_iterations(run), s)
