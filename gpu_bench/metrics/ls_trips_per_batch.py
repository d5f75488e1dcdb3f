"""Line-search trips (K7a at a candidate) a traced batch runs in the
synchronous loop: its ``srbd::ls_trip`` spans per solve span, summed over
the SQP iterations."""

from gpu_bench.metrics.host_syncs_per_batch import per_solve


def read(run):
    return per_solve(run.trace, "ls_trip")
