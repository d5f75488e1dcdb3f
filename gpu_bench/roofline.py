"""The table of peaks and the roofline arithmetic of the kernel readers.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth.
"""

from __future__ import annotations

from typing import Optional

PEAK_FP32 = 67e12       # FLOP/s
PEAK_BYTES = 3.35e12    # bytes/s


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def share_pct(ops_per_lane: float, bytes_per_lane: float, lanes: int,
              device_s: float) -> Optional[float]:
    """A kernel's share of its roofline, in %: the bound of ``lanes``
    lane-calls over the device seconds its kernels took; None where they
    took none."""
    if device_s <= 0 or lanes <= 0:
        return None
    return 100.0 * bound_s(ops_per_lane * lanes,
                           bytes_per_lane * lanes) / device_s


def traced_iterations(run) -> int:
    """SQP iterations of the traced batches' solves: the lane-calls the
    inputs need (one linearization and QP per iteration), whatever the
    launches' widths."""
    return sum(b["iters"] for b in run.batches if b["traced"])
