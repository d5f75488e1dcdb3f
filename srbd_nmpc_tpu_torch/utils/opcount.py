"""Floating-point operations of the port's CUDA kernels, counted on the
kernels' own arithmetic.

Every kernel source's per-thread and per-team bodies also compile as host
C++. Built with ``-DSRBD_OPCOUNT`` their scalar is ``OpCount``
(``csrc/srbd_dev.cuh``), a double that counts each + - * / and each sqrt,
rsqrt, sin, cos and log done on it. Each ``count_*`` function takes the
arguments of the kernel's wrapper (on any device), runs the host entry of
the launches the wrapper makes on ``lanes`` scenarios spread evenly over the
batch (each lane's data-dependent branches as its inputs take them; a team
emulated member by member at the card's width, ``TEAM``) and returns the
operations scaled to the whole batch. The inputs are rounded to float32
first, as the card sees them. The float32 forms are counted (K1's gains
body: its float32 plane pass).

    ops = opcount.count_sqp_onepass(*args, reg=reg)   # at args' batch width

Used for the roofline bound of ``chip_smoke.py``; the work the wrapper does
around a launch in PyTorch (forming dx0, for one) is not counted.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from srbd_nmpc_tpu_torch.models import merit_kernel, srbd_linearize
from srbd_nmpc_tpu_torch.ops import sqp_kernel, sqp_planes, sqp_stage
from srbd_nmpc_tpu_torch.utils import build

SOURCES = ("sqp_planes", "sqp_onepass", "sqp_twopass", "linearize",
           "riccati", "merit")
# the card's team width of the team Riccati passes (K1s-B, K3's, K6's)
TEAM = 16
FLAGS = ("-O2", "-ffp-contract=off", "-DSRBD_OPCOUNT", "-fno-strict-aliasing")
LANES = 1024
F64 = torch.float64

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_source(name: str) -> str:
    """g++ build of ``csrc/<name>.cu`` with the counting scalar; its path."""
    return build.build_host(f"{build.CSRC}/{name}.cu", flags=FLAGS)


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_source(name))
            lib.srbd_opcount_take.restype = ctypes.c_longlong
            _libs[name] = lib
        return _libs[name]


def _lanes(B: int, lanes: int) -> torch.Tensor:
    return torch.linspace(0, B - 1, min(B, lanes)).round().long()


def _host(idx, *ts):
    """The lanes ``idx`` of each tensor, float32-rounded, as f64 on the CPU."""
    return [t[..., idx.to(t.device)].to(torch.float32).to("cpu", F64)
            .contiguous() for t in ts]


def _consts(k: torch.Tensor) -> torch.Tensor:
    return k.to("cpu", F64).contiguous()


def _empty(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=F64)


def _count(source: str, entry: str, tensors, tail, head=()) -> int:
    """Run ``entry`` of the counting build (``tensors``: None passes a null
    pointer; ``head``: leading C ints; ``tail``: its trailing arguments,
    Python ints as C ints, floats as doubles); the operations it did."""
    lib = _lib(source)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(head) + [ctypes.c_void_p] * len(
        tensors) + [ctypes.c_int if isinstance(v, int) else ctypes.c_double
                    for v in tail]
    fn.restype = ctypes.c_int
    lib.srbd_opcount_take()
    if fn(*head, *(None if t is None else t.data_ptr() for t in tensors),
          *tail) != 0:
        raise RuntimeError(f"{entry} failed")
    return lib.srbd_opcount_take()


def _run(source: str, entry: str, tensors, tail, B: int, n: int,
         head=()) -> float:
    """``_count`` on ``n`` lanes, scaled to ``B`` lanes."""
    return _count(source, entry, tensors, tail, head) * B / n


def count_sqp_planes(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                     alpha, x0s, mu_b, theta_b, reg=0.0, rank6=False,
                     factor=False, lanes=LANES):
    """K1 (``sqp_planes.sqp_qp_solve_onepass_planes``), the stage body that
    ``rank6`` / ``factor`` pick, as the wrapper picks it: its three
    launches."""
    N, B = us.shape[0], xa.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    xa, us, xra, dxc, duc, alpha, x0s = _host(idx, xa, us, xra, dxc, duc,
                                              alpha, x0s)
    kc = sqp_stage.kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc)
    body = sqp_planes._body(rank6, factor, lambda: kc.rank6)
    dx = _empty(N + 1, 12, n)
    dx[0] = x0s - (xa[0] + alpha[None] * dxc[0])
    du, out5 = _empty(N, 12, n), _empty(5, n)
    scratch = (_empty(N, sqp_planes._C, n), _empty(N, sqp_planes._M_C, n),
               _empty(sqp_planes._T_C, n))
    parks = [_empty(*s) for s in sqp_planes.park_shapes(body, N, n) if s]
    entry = {"gains": "srbd_sqp_planes_split_host",
             "rank6": "srbd_sqp_planes_split_rank6_host",
             "factor": "srbd_sqp_planes_split_factor_host"}[body]
    return _run("sqp_planes", entry,
                (_consts(kc.block), xa, us, xra, dxc, duc, alpha, dx, dx[1:],
                 du, *out5, *scratch, *parks),
                (N, n, float(mu_b), float(theta_b), float(reg)), B, n,
                head=(TEAM, 0))


def _onepass(cand, params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
             alpha, dx0, mu_b, theta_b, reg, lanes):
    N, B = us.shape[0], xa.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    xa, us, xra, dxc, duc, alpha, dx0 = _host(idx, xa, us, xra, dxc, duc,
                                              alpha, dx0)
    consts = _consts(sqp_stage.kernel_constants(params, Q_w, Qf_w, R_w, Ac,
                                                bc).block)
    dx = _empty(N + 1, 12, n)
    dx[0] = dx0
    du, out5 = _empty(N, 12, n), _empty(5, n)
    scratch = (_empty(N, sqp_planes._C, n), _empty(N, sqp_kernel.MERIT_C, n),
               _empty(sqp_planes._T_C, n), _empty(N, 12, 12, n),
               _empty(N, 12, n))
    return _run("sqp_onepass", "srbd_sqp_onepass_split_host",
                (consts, xa, us, xra, dxc, duc, alpha, dx, dx[1:], du, *out5,
                 *scratch),
                (N, n, float(mu_b), float(theta_b), float(reg)), B, n,
                head=(TEAM, 0, int(cand)))


def count_sqp_onepass_cand(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc,
                           duc, alpha, x0s, mu_b, theta_b, reg=0.0,
                           lanes=LANES):
    """K3a (``sqp_kernel.sqp_qp_solve_onepass_cand``): its three
    launches."""
    dx0 = x0s - (xa[0] + alpha[None, :] * dxc[0])
    return _onepass(True, params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc,
                    duc, alpha, dx0, mu_b, theta_b, reg, lanes)


def count_sqp_onepass(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dx0, mu_b,
                      theta_b, reg=0.0, lanes=LANES):
    """K3b (``sqp_kernel.sqp_qp_solve_onepass``)."""
    return _onepass(False, params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, xa,
                    us, xa[0, 0], dx0, mu_b, theta_b, reg, lanes)


def count_sqp_twopass_bwd(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, mu_b,
                          theta_b, reg=0.0, lanes=LANES):
    """K4a (``sqp_kernel.sqp_qp_backward``): its four launches (K5's two
    into K4a's buffers, the terminal-and-merit pass, K6a's team pass with
    Acl and bcl)."""
    N, B = us.shape[0], xa.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    xa, us, xra = _host(idx, xa, us, xra)
    consts = _consts(sqp_kernel._k4_constants(params, Q_w, Qf_w, R_w, Ac, bc,
                                              "cpu"))
    A, Bm, Reff = (_empty(N, 12, 12, n) for _ in range(3))
    b, reff, mer, q = (_empty(N, 12, n), _empty(N, 12, n), _empty(N, 8, n),
                       _empty(N + 1, 12, n))
    ops = _count("linearize", "srbd_linearize_split_host",
                 (consts, xa, xa[1:], us, xra, A, Bm, b, Reff, reff, q, mer),
                 (N, n, float(mu_b), float(theta_b)))
    ops += _count("sqp_twopass", "srbd_k4s_merit_host",
                  (consts, xa, xra, mer, q, *_empty(4, n)), (N, n))
    qc = consts[srbd_linearize._K_Q:].contiguous()     # [Q | Qf]
    ops += _count("riccati", "srbd_riccati_bwd_team_acl_host",
                  (A, Bm, b, qc, Reff, q, reff, _empty(N, 12, 12, n),
                   _empty(N, 12, n), _empty(N, 12, 12, n), _empty(N, 12, n)),
                  (N, n, float(reg)), head=(TEAM, 0))
    return ops * B / n


def count_sqp_twopass_fwd(Acl, K, bcl, kv, q, reff, qN, dx0, lanes=LANES):
    """K4b (``sqp_kernel.sqp_qp_forward``)."""
    N, B = Acl.shape[0], Acl.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    ins = _host(idx, Acl, K, bcl, kv, q, reff, qN, dx0)
    outs = (_empty(N, 12, n), _empty(N, 12, n), _empty(n))
    return _run("sqp_twopass", "srbd_sqp_twopass_fwd_host_f64", (*ins, *outs),
                (N, n), B, n)


def count_linearize(params, Q_w, R_w, Ac, bc, xs, xn, us, xr, mu_b, theta_b,
                    lanes=LANES):
    """K5 (``srbd_linearize.linearize``): its two launches."""
    N, _, B = xs.shape
    idx = _lanes(B, lanes)
    n = len(idx)
    ins = _host(idx, xs, xn, us, xr)
    consts = _consts(srbd_linearize.kernel_constants(params, Q_w, R_w, Ac, bc))
    # the C entry's outputs: A, B, b, R_eff, r_eff, q, merit partials
    outs = (_empty(N, 12, 12, n), _empty(N, 12, 12, n), _empty(N, 12, n),
            _empty(N, 12, 12, n), _empty(N, 12, n), _empty(N, 12, n),
            _empty(N, 8, n))
    return _run("linearize", "srbd_linearize_split_host", (consts, *ins, *outs),
                (N, n, float(mu_b), float(theta_b)), B, n)


def count_riccati_bwd(A, Bm, b, Q, R, q, r, reg=0.0, lanes=LANES):
    """K6a/K6b (``riccati_kernel.lqr_backward``): Q a (Q, Qf) pair (K6a) or
    per-stage [N+1,12,12,B] (K6b); the team kernel."""
    N, B = A.shape[0], A.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    const_q = isinstance(Q, tuple)
    A, Bm, b, R, q, r = _host(idx, A, Bm, b, R, q, r)
    Qptr = (_consts(torch.cat([Q[0].reshape(-1), Q[1].reshape(-1)])
                    .to(torch.float32)) if const_q else _host(idx, Q)[0])
    return _run("riccati", "srbd_riccati_bwd_team_host",
                (A, Bm, b, Qptr, R, q, r, _empty(N, 12, 12, n),
                 _empty(N, 12, n)), (N, n, float(reg), int(const_q)), B, n,
                head=(TEAM, 0))


def count_riccati_fwd(A, Bm, b, K, k, x0, lanes=LANES):
    """K6c (``riccati_kernel.lqr_forward``)."""
    N, B = A.shape[0], A.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    ins = _host(idx, A, Bm, b, K, k, x0)
    return _run("riccati", "srbd_riccati_fwd_host_f64",
                (*ins, _empty(N, 12, n), _empty(N, 12, n)), (N, n), B, n)


def count_merit_alpha(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du, alpha,
                      mu_b, theta_b, lanes=LANES):
    """K7a (``merit_kernel.merit_alpha``): its two launches."""
    N, B = u.shape[0], x.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    x, dx, u, du, xr, alpha = _host(idx, x, dx, u, du, xr, alpha)
    consts = _consts(merit_kernel.kernel_constants(params, Q_w, Qf_w, R_w, Ac,
                                                   bc))
    return _run("merit", "srbd_merit_alpha_split_host",
                (consts, x, dx, u, du, xr, alpha, _empty(n), _empty(n)),
                (N, n, float(mu_b), float(theta_b)), B, n)


def count_merit(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, mu_b, theta_b,
                with_grad=True, lanes=LANES):
    """K7b (``merit_kernel.merit``), the variant ``with_grad`` picks; the
    terminal gradient row the wrapper adds is not counted."""
    N, B = u.shape[0], x.shape[-1]
    idx = _lanes(B, lanes)
    n = len(idx)
    x, u, xr = _host(idx, x, u, xr)
    consts = _consts(merit_kernel.kernel_constants(params, Q_w, Qf_w, R_w, Ac,
                                                   bc))
    return _run("merit", "srbd_merit_host_f64",
                (consts, x, u, xr, _empty(4, n), _empty(N + 1, 12, n),
                 _empty(N, 12, n)),
                (N, n, float(mu_b), float(theta_b), int(with_grad)), B, n)
