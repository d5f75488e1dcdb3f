"""Fused SQP trips (K1, or K3 on the dense route) a traced batch launches
in the speculative loop: its ``srbd::trip[<width>]`` spans per solve span,
the bootstrap included, whatever their width."""

from gpu_bench.metrics.host_syncs_per_batch import per_solve


def read(run):
    return per_solve(run.trace, "trip")
