"""Accuracy metrics of a batched solve, in numpy.

Copies of ``bench.parity_metric`` / ``bench.oracle_errors``: ``bench.py``
imports JAX at module level, and the port must run without JAX, so it
carries its own. ``oracle_solve`` is the oracle's single solve that
``oracle_errors`` runs per scenario.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from srbd_nmpc_tpu_torch.utils.build import build_host

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORACLE_SRC = os.path.join(_REPO, "native", "srbd_oracle.cpp")


def parity_metric(u_test, u_ref) -> float:
    """Worst per-element relative error between two force trajectories,
    the denominator floored at 1 % of the reference's max magnitude so
    near-zero elements do not blow up the ratio."""
    u_test = np.asarray(u_test, np.float64)
    u_ref = np.asarray(u_ref, np.float64)
    scale = np.maximum(np.abs(u_ref), 0.01 * np.max(np.abs(u_ref)) + 1e-30)
    return float(np.max(np.abs(u_test - u_ref) / scale))


def oracle_solve(x0, N: int = 20, sqp_max_iter: int = 15):
    """Solve the benchmark problem (default options) from ``x0 [12]`` with
    the independent f64 C++ oracle ``native/srbd_oracle.cpp``, built with
    g++ at first use. Returns (converged, x [N+1, 12], u [N, 12])."""
    lib = ctypes.CDLL(build_host(ORACLE_SRC))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.srbd_nmpc_solve.restype = ctypes.c_int
    lib.srbd_nmpc_solve.argtypes = [dp] * 2 + [ctypes.c_int] * 2 + [dp] * 5

    pvec = np.array([15.0, 0.015, 0.541667, 0.516667, 1.0416667,
                     0.0, -0.1, 0.0, 0.0, 0.1, 0.0, 0.1, 5.0])
    wvec = np.concatenate([
        np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 10.0]),
        np.array([0.0001]),
        np.array([0.5, 0.5, 0.5, 0.01, 0.01, 0.01,
                  100, 100, 100, 0, 0, 100.0]),
    ])
    x_ref = np.zeros(12)
    x_ref[2], x_ref[6], x_ref[8] = 0.2, 0.5, 1.0

    def p(a):
        return a.ctypes.data_as(dp)

    x0 = np.ascontiguousarray(np.asarray(x0, np.float64))
    x_out = np.zeros((N + 1) * 12)
    u_out = np.zeros(N * 12)
    info = np.zeros(5)
    ret = lib.srbd_nmpc_solve(p(pvec), p(wvec), N, sqp_max_iter, p(x0),
                              p(x_ref), p(x_out), p(u_out), p(info))
    return ret == 1, x_out.reshape(N + 1, 12), u_out.reshape(N, 12)


def oracle_errors(u_test, x0s, N: int = 20, sqp_max_iter: int = 15) -> float:
    """Worst ``parity_metric`` of solves ``u_test [S, N, 12]`` (started from
    ``x0s [S, 12]`` on the benchmark problem with the default options)
    against ``oracle_solve``. Scenarios the oracle itself does not converge
    on are skipped; returns -1.0 if none is left."""
    u_np = np.asarray(u_test, np.float64)
    worst, n_used = 0.0, 0
    for i in range(u_np.shape[0]):
        ok, _, u_c = oracle_solve(x0s[i], N, sqp_max_iter)
        if not ok:
            continue
        worst = max(worst, parity_metric(u_np[i], u_c))
        n_used += 1
    return worst if n_used else -1.0
