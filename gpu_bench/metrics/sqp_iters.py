"""Mean SQP iterations a solve of the window took (``NmpcInfo.sqp_iters``),
over every solve of every batch."""


def read(run):
    n = sum(b["n"] for b in run.batches)
    return sum(b["iters"] for b in run.batches) / n if n else None
