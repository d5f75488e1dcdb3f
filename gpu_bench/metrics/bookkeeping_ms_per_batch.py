"""Device milliseconds a traced batch spends in operations that are not
the program's own kernels: PyTorch's elementwise, where, index, copy, cat,
reduction and sort kernels and the runtime's copies and fills
(``trace.LIBRARY_MARKS``), the SQP loop's bookkeeping."""

from gpu_bench.trace import LIBRARY_MARKS


def read(run):
    if run.trace is None:
        return None
    n = sum(1 for b in run.batches if b["traced"])
    s, count = run.trace.seconds(
        lambda name: any(m in name for m in LIBRARY_MARKS))
    return 1e3 * s / n if n and count else None
