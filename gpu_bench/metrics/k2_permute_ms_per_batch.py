"""Device milliseconds a traced batch spends in K2, the compaction's lane
gather and scatter (the ``take_lanes`` and ``set_lanes`` kernels, in
either element size), per ``srbd::solve`` span. The program marks each
tier crossing's K2 calls as a ``srbd::compact[<width>]`` span; a trace
that holds none inside a solve span reads None (a program without those
spans, or a route that does not compact)."""

from gpu_bench.metrics.host_syncs_per_batch import (solve_spans,
                                                    spans_in_solves)


def read(run):
    t = run.trace
    solves = solve_spans(t)
    if not solves or not spans_in_solves(t, "compact"):
        return None
    s, _ = t.seconds(lambda name: "take_lanes" in name
                     or "set_lanes" in name)
    return 1e3 * s / len(solves)
