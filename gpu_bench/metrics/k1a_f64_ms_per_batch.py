"""Device milliseconds a traced batch spends in K1s-A's float64 form, the
plane pass of K1 for a float64 batch (every kernel whose name holds
``k1s_planes_f64``, one or more launches a K1 call), per ``srbd::solve``
span. A trace without a solve span reads None; a float32 batch, which
launches none of them, reads 0."""

from gpu_bench.metrics.host_syncs_per_batch import solve_spans


def read(run):
    t = run.trace
    solves = solve_spans(t)
    if not solves:
        return None
    s, _ = t.seconds(lambda name: "k1s_planes_f64" in name)
    return 1e3 * s / len(solves)
