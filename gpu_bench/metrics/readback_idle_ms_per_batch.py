"""Device milliseconds a traced batch stands idle behind its read-backs:
the device's idle gaps (between the union of its operations' intervals)
whose start lies inside a ``srbd::readback`` span of a solve, each summed
whole, per solve span. The device ran dry while the host was blocked on
the read, and the gap lasts through the host's next launch. Gaps that
open outside every solve span are the harness's."""

import bisect

from gpu_bench.metrics.host_syncs_per_batch import (solve_spans,
                                                    spans_in_solves)


def read(run):
    t = run.trace
    solves = solve_spans(t)
    if not solves or not t.ops:
        return None
    reads = sorted((s, e) for _, s, e in spans_in_solves(t, "readback"))
    starts = [s for s, _ in reads]
    idle = 0.0
    for (_, e0), (s1, _) in zip(t.busy, t.busy[1:]):
        i = bisect.bisect_right(starts, e0) - 1
        if i >= 0 and e0 <= reads[i][1]:
            idle += s1 - e0
    return 1e3 * idle / len(solves)
