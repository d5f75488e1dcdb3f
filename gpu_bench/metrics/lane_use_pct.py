"""Share of the launched lane-calls, in %, that the traced solves needed:
their SQP iterations (``roofline.traced_iterations``, the base of the
roofline metrics) over the lanes the loop launched, the sum of the widths
of the ``srbd::trip[<width>]`` spans (speculative loop) or, without
those, of the ``srbd::sqp_iter[<width>]`` spans (synchronous loop). A
kernel's share of its roofline is about its share per launched lane times
this."""

from gpu_bench import roofline
from gpu_bench.metrics.host_syncs_per_batch import (solve_spans,
                                                    spans_in_solves, width)


def read(run):
    t = run.trace
    if not solve_spans(t):
        return None
    launched = (sum(width(n) for n, _, _ in spans_in_solves(t, "trip"))
                or sum(width(n) for n, _, _ in spans_in_solves(t, "sqp_iter")))
    if not launched:
        return None
    return 100.0 * roofline.traced_iterations(run) / launched
