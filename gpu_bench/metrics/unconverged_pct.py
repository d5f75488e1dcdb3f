"""Share of the window's solves, in %, that ended at the iteration cap
(MAX_ITER_REACHED) or at the step-length floor (MIN_STEP_LENGTH_REACHED):
the solver's answer, not a failure."""


def read(run):
    n = sum(b["n"] for b in run.batches)
    return 100.0 * sum(b["unconv"] for b in run.batches) / n if n else None
