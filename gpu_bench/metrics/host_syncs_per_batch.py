"""Device-to-host reads a traced batch makes inside its solve: the
program's ``srbd::readback`` spans inside its ``srbd::solve`` spans, per
solve span. Each read holds the host until the device has run dry.

The helpers below read the program's spans (``srbd_nmpc_tpu_torch/utils/
profiling.py``: host ranges on the profiler's clock, one ``srbd::solve``
span a batch, every other span of the batch inside it) for each reader of
them. Spans outside every solve span are not the program's batches'."""

SOLVE = "srbd::solve"


def solve_spans(trace):
    """(start, end) of the trace's ``srbd::solve`` spans: none without a
    trace."""
    if trace is None:
        return []
    return [(s, e) for n, s, e in trace.host if n == SOLVE]


def spans_in_solves(trace, name: str):
    """The spans ``srbd::<name>`` and ``srbd::<name>[<width>]`` (name,
    start, end) that lie inside a solve span."""
    solves = solve_spans(trace)
    full = f"srbd::{name}"
    return [h for h in trace.host
            if (h[0] == full or h[0].startswith(full + "["))
            and any(s <= h[1] and h[2] <= e for s, e in solves)]


def width(name: str) -> int:
    """The lanes a span ``srbd::<name>[<width>]`` launched."""
    return int(name[name.index("[") + 1:-1])


def per_solve(trace, name: str):
    """``srbd::<name>`` spans per solve span; None without a solve span."""
    solves = solve_spans(trace)
    if not solves:
        return None
    return len(spans_in_solves(trace, name)) / len(solves)


def read(run):
    return per_solve(run.trace, "readback")
