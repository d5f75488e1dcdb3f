"""Device milliseconds a traced batch spends in K1s-B, the team Riccati pass
of K1 (every kernel whose name holds ``k1s_riccati_team``: its float32 form
``k1s_riccati_team_kernel`` and its float64 form
``k1s_riccati_team_f64_kernel``), per ``srbd::solve`` span. A trace without
a solve span reads None; a batch that launches neither, 0."""

from gpu_bench.metrics.host_syncs_per_batch import solve_spans


def read(run):
    t = run.trace
    solves = solve_spans(t)
    if not solves:
        return None
    s, _ = t.seconds(lambda name: "k1s_riccati_team" in name)
    return 1e3 * s / len(solves)
