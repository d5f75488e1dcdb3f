"""Share of the traced stretch's wall time, in %, in which no operation ran
on the device: 1 - (union of the device operations' intervals) / (the
traced batches' wall time)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
