"""Fused SQP QP solves in the dense stage layout: the one-pass trip at a
candidate (K3a) or at the iterate (K3b), and the two-pass solve (K4).

Counterpart of ``srbd_nmpc_tpu/ops/sqp_pallas.py``:

- ``sqp_qp_solve_onepass_cand`` (K3a, ``_onepass_cand_kernel``): one SQP
  trip at the line-search candidate (xa + alpha dxc, us + alpha duc) with a
  per-scenario alpha; the dense route's speculative trips.
- ``sqp_qp_solve_onepass`` (K3b, ``_onepass_kernel``): the same trip at the
  iterate with dx0 given; the dense route's bootstrap and synchronous
  ``fused`` iteration.
- ``sqp_qp_solve`` (K4, ``_bwd_kernel`` then ``_fwd_kernel``): linearize
  with the dense Euler sensitivities and the full constraint matrix, run a
  dense Riccati backward pass, then roll forward. No engine route runs it:
  it is the two-pass oracle the one-pass trip is held against.

Each has a plain PyTorch version (``*_ref``; any device and dtype, stage
bodies in ``ops.sqp_stage``). CPU tensors run the plain version; CUDA
tensors launch the hand-written kernels, float32 only, or raise: K3a and
K3b as three launches (``csrc/sqp_onepass.cu``'s plane pass, the team
Riccati pass of ``csrc/sqp_planes.cu`` through
``sqp_planes.riccati_team_cuda``, the closed-loop rollout); K4a backward as
four launches (K5's stage pass and dense write of ``csrc/linearize.cu``
into K4a's buffers, the terminal-and-merit pass of ``csrc/sqp_twopass.cu``,
K6a's team pass of ``csrc/riccati.cu`` also writing Acl and bcl); K4b
forward one launch of ``csrc/sqp_twopass.cu``. The K3 wrappers take the
constants block ``sqp_stage.kernel_constants`` as ``consts=`` so that a
solve builds it (and checks ``Ac``) once.

Returns follow the JAX functions: (dx [N+1,12,B], du [N,12,B], dphi [B],
(theta, phi, max|defect|, min constraint) [B] at the evaluation point).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd_linearize, srbd_soa
from srbd_nmpc_tpu_torch.models.srbd import NG, NU, NX, SRBDParams
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops import sqp_planes
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.ops.sqp_stage import (_accumulate_merit,
                                               _backward_stage_structured,
                                               _forward_rollout,
                                               _split_leg_blocks,
                                               kernel_constants)
from srbd_nmpc_tpu_torch.utils.build import check_cuda_f32, load_kernel

# K4a's constants block (offsets match csrc/sqp_twopass.cu): mass, dt,
# Iinv[9], foot[6], then Ac [24,12], bc [24], R, Q, Qf [12,12]: K5's block
# (csrc/linearize.cu) then Qf
_K4_LEN = 761
THREADS = 128
# K3's merit terms per stage [N, MERIT_C, B]: 0.5 |b|^2, the stage's phi
# term, max |b|, min constraint (csrc/sqp_onepass.cu)
MERIT_C = 4

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches = {"sqp_onepass_cand": 0, "sqp_onepass": 0,
            "sqp_twopass_bwd": 0, "sqp_twopass_fwd": 0}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                Tuple[torch.Tensor, ...]]


def _widen(c: torch.Tensor, Bt: int) -> torch.Tensor:
    return c[..., None].expand(c.shape + (Bt,))


def _onepass_ref(params, Q_w, Qf_w, R_w, Ac, bc, xs, us, xra, dx0, mu_b,
                 theta_b, reg) -> Outputs:
    """The one-pass trip at the trajectory (xs [N+1,12,B], us [N,12,B])."""
    N = us.shape[0]
    Bt = xs.shape[-1]
    dtype = xs.dtype
    Ac1, Ac2 = _split_leg_blocks(Ac)
    Ac1_b, Ac2_b = _widen(Ac1.to(dtype), Bt), _widen(Ac2.to(dtype), Bt)
    Rw_b, Qw_b = _widen(R_w.to(dtype), Bt), _widen(Q_w.to(dtype), Bt)
    Qf_b = _widen(Qf_w.to(dtype), Bt)
    bc_col = bc.to(dtype)[:, None]

    eN = xs[N] - xra[N]
    qN = sm.mv(Qf_b, eN)
    phiN = 0.5 * sm.sum_rows(eN * qN)
    P, p = Qf_b, qN
    parks = [[None] * N for _ in range(6)]     # Acl, K, bcl, kv, q, reff
    acc = None
    for k in reversed(range(N)):
        (P, p, Acl, K, bcl, kv, q, reff, b, con, b_bar, Ru) = \
            _backward_stage_structured(params, Ac1_b, Ac2_b, bc_col, Rw_b,
                                       Qw_b, xs[k], xs[k + 1], us[k], xra[k],
                                       P, p, reg, mu_b, theta_b)
        for lst, v in zip(parks, (Acl, K, bcl, kv, q, reff)):
            lst[k] = v
        acc = _accumulate_merit(acc, b, con, b_bar, us[k], Ru, xs[k], xra[k],
                                q, phiN)
    dx_rest, du, dphi = _forward_rollout(dx0, *parks, qN)
    return torch.cat([dx0[None], dx_rest]), du, dphi, acc


def sqp_qp_solve_onepass_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa,
                             us, xra, dx0, mu_b: float, theta_b: float,
                             reg: float = 0.0) -> Outputs:
    """Plain version of K3b: the fused SQP QP solve at (xa, us) with
    dx0 = x0 - xa[0] given."""
    return _onepass_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dx0,
                        mu_b, theta_b, reg)


def sqp_qp_solve_onepass_cand_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc,
                                  xa, us, xra, dxc, duc, alpha, x0s,
                                  mu_b: float, theta_b: float,
                                  reg: float = 0.0) -> Outputs:
    """Plain version of K3a: the fused SQP QP solve at the candidate
    (xa + alpha dxc, us + alpha duc), alpha [B], x0s [12, B] the raw
    initial states."""
    a = alpha[None, None, :]
    dx0 = x0s - (xa[0] + alpha[None, :] * dxc[0])
    return _onepass_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa + a * dxc,
                        us + a * duc, xra, dx0, mu_b, theta_b, reg)


def sqp_qp_backward_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us,
                        xra, mu_b: float, theta_b: float, reg: float = 0.0):
    """Plain version of K4a: dense linearization and backward Riccati.
    Returns (Acl, K [N,12,12,B], bcl, kv, q, reff [N,12,B], qN [12,B],
    (theta, phi, max|defect|, min constraint) at (xa, us))."""
    N = us.shape[0]
    Bt = xa.shape[-1]
    dtype = xa.dtype
    Ac_b = _widen(Ac.to(dtype), Bt)
    Rw_b, Qw_b = _widen(R_w.to(dtype), Bt), _widen(Q_w.to(dtype), Bt)
    Qf_b = _widen(Qf_w.to(dtype), Bt)
    bc_col = bc.to(dtype)[:, None]

    eN = xa[N] - xra[N]
    qN = sm.mv(Qf_b, eN)
    phiN = 0.5 * sm.sum_rows(eN * qN)
    P, p = Qf_b, qN
    outs = [[None] * N for _ in range(6)]      # Acl, K, bcl, kv, q, reff
    acc = None
    for k in reversed(range(N)):
        x, xn, u, xr = xa[k], xa[k + 1], us[k], xra[k]
        A, B = srbd_soa.euler_AB(params, x, u)
        b = srbd_soa.rk4(params, x, u) - xn
        con = sm.mv(Ac_b, u) + bc_col
        b_bar, db, ddb = relaxed_log_barrier(con, mu_b, theta_b)
        Reff = Rw_b + sm.mtm(Ac_b, Ac_b * ddb[:, None])
        Ru = sm.mv(Rw_b, u)
        reff = Ru + sm.mtv(Ac_b, db)
        q = sm.mv(Qw_b, x - xr)

        PA = sm.mm(P, A)
        G = sm.add_diag(Reff + sm.mtm(B, sm.mm(P, B)), reg)
        H = sm.mtm(B, PA)
        L, dinv = sm.cholesky(G)
        K = -sm.chol_solve(L, dinv, H)
        Pb_p = sm.mv(P, b) + p
        kv = -sm.chol_solve_vec(L, dinv, sm.mtv(B, Pb_p) + reff)
        P = sm.sym(Qw_b + sm.mtm(A, PA) + sm.mtm(H, K))
        p = q + sm.mtv(A, Pb_p) + sm.mtv(H, kv)
        for lst, v in zip(outs, (A + sm.mm(B, K), K, b + sm.mv(B, kv), kv, q,
                                 reff)):
            lst[k] = v
        acc = _accumulate_merit(acc, b, con, b_bar, u, Ru, x, xr, q, phiN)
    Acl, K, bcl, kv, q, reff = (torch.stack(lst) for lst in outs)
    return Acl, K, bcl, kv, q, reff, qN, acc


def sqp_qp_forward_ref(Acl, K, bcl, kv, q, reff, qN, dx0):
    """Plain version of K4b: rollout of K4a's products from dx0 [12, B].
    Returns (dx [N,12,B] for stages 1..N, du [N,12,B], dphi [B])."""
    return _forward_rollout(dx0, Acl, K, bcl, kv, q, reff, qN)


def sqp_qp_solve_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra,
                     dx0, mu_b: float, theta_b: float, reg: float = 0.0
                     ) -> Outputs:
    """Plain version of K4 (backward, then forward)."""
    *prods, aux = sqp_qp_backward_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa, us,
                                      xra, mu_b, theta_b, reg)
    dx_rest, du, dphi = sqp_qp_forward_ref(*prods, dx0)
    return torch.cat([dx0[None], dx_rest]), du, dphi, aux


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _fn(source: str, name: str, nptr: int, tail):
    fn = getattr(load_kernel(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nptr + tail
        fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lib():
    lib = load_kernel("sqp_onepass")
    if lib.srbd_k3s_planes_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.srbd_k3s_planes_launch.argtypes = [P] * 10 + [I, I, F, F, I, P]
        lib.srbd_k3s_rollout_launch.argtypes = [P] * 14 + [I, I, P]
        for fn in (lib.srbd_k3s_planes_launch, lib.srbd_k3s_rollout_launch):
            fn.restype = ctypes.c_int
    return lib


def _launch(kc, xa, us, xra, dxc, duc, alpha, dx, du, out5, mu_b, theta_b,
            reg, cand, stream):
    """K3 as three launches: the plane pass (pack [N, 87, B], merit terms
    [N, MERIT_C, B], terminal rows [13, B]), the team Riccati pass (K, kv),
    the rollout; each launch's return code checked as it is made."""
    N, Bt = us.shape[0], xa.shape[-1]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xa.device)

    pack, mer = empty(N, sqp_planes._C, Bt), empty(N, MERIT_C, Bt)
    term = empty(sqp_planes._T_C, Bt)
    opt = (lambda t: t.data_ptr()) if cand else (lambda t: None)
    lib = _lib()
    _check(lib.srbd_k3s_planes_launch(
        kc.data_ptr(), xa.data_ptr(), us.data_ptr(), xra.data_ptr(),
        opt(dxc), opt(duc), opt(alpha), pack.data_ptr(), mer.data_ptr(),
        term.data_ptr(), N, Bt, float(mu_b), float(theta_b), int(cand),
        stream), "sqp_onepass plane pass")
    K, kv = sqp_planes.riccati_team_cuda(kc, pack, term, reg, stream)
    _check(lib.srbd_k3s_rollout_launch(
        kc.data_ptr(), pack.data_ptr(), mer.data_ptr(), term.data_ptr(),
        K.data_ptr(), kv.data_ptr(), dx.data_ptr(), dx[1:].data_ptr(),
        du.data_ptr(), *(out5[i].data_ptr() for i in range(5)), N, Bt,
        stream), "sqp_onepass rollout")


def _onepass_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                  alpha, dx0, mu_b, theta_b, reg, consts, cand: bool
                  ) -> Outputs:
    N = us.shape[0]
    Bt = xa.shape[-1]
    shapes = [("xa", xa, (N + 1, NX, Bt)), ("us", us, (N, NU, Bt)),
              ("xra", xra, (N + 1, NX, Bt)), ("dx0", dx0, (NX, Bt))]
    if cand:
        shapes += [("dxc", dxc, (N + 1, NX, Bt)), ("duc", duc, (N, NU, Bt)),
                   ("alpha", alpha, (Bt,))]
    for name, t, shape in shapes:
        check_cuda_f32(name, t, shape)
    if consts is None:
        consts = kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc)
    dev = xa.device
    xa, us, xra = (t.contiguous() for t in (xa, us, xra))
    if cand:
        dxc, duc, alpha = (t.contiguous() for t in (dxc, duc, alpha))

    dx = torch.empty((N + 1, NX, Bt), dtype=torch.float32, device=dev)
    dx[0] = dx0
    du = torch.empty((N, NU, Bt), dtype=torch.float32, device=dev)
    out5 = torch.empty((5, Bt), dtype=torch.float32, device=dev)
    _launch(consts.block, xa, us, xra, dxc, duc, alpha, dx, du, out5, mu_b,
            theta_b, reg, cand, _stream(dev))
    launches["sqp_onepass_cand" if cand else "sqp_onepass"] += 1
    return dx, du, out5[0], (out5[1], out5[2], out5[3], out5[4])


def _k3a_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc, alpha,
              x0s, mu_b, theta_b, reg=0.0, consts=None) -> Outputs:
    """K3a on the card (the public entry on CUDA tensors), for the card
    tests and chip_smoke.py. CUDA tensors only; dx0 is formed here."""
    check_cuda_f32("x0s", x0s, (NX, xa.shape[-1]))
    dx0 = x0s - (xa[0] + alpha[None, :] * dxc[0])
    return _onepass_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc,
                         duc, alpha, dx0, mu_b, theta_b, reg, consts,
                         cand=True)


def _k3b_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dx0, mu_b,
              theta_b, reg=0.0, consts=None) -> Outputs:
    """K3b on the card, as ``_k3a_cuda``."""
    return _onepass_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, None,
                         None, None, dx0, mu_b, theta_b, reg, consts,
                         cand=False)


def _dispatch(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise TypeError(f"unsupported device {t.device}")
    return False


def sqp_qp_solve_onepass(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us,
                         xra, dx0, mu_b: float, theta_b: float,
                         reg: float = 0.0, fold: bool = True, consts=None
                         ) -> Outputs:
    """One fused SQP trip at (xa, us), dx0 [12, B] = x0 - xa[0]: the
    contract of the JAX ``sqp_qp_solve_onepass`` at any width B. ``fold``
    picks the TPU kernel's grid layout (the rollout as the epilogue of the
    last backward step, or N more grid steps); both are the same recursion,
    which the port runs as one loop. Requires ``Ac`` leg-block-diagonal
    (checked)."""
    del fold
    if _dispatch(xa):
        return _k3b_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dx0,
                         mu_b, theta_b, reg, consts=consts)
    return sqp_qp_solve_onepass_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa, us,
                                    xra, dx0, mu_b, theta_b, reg)


def sqp_qp_solve_onepass_cand(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa,
                              us, xra, dxc, duc, alpha, x0s, mu_b: float,
                              theta_b: float, reg: float = 0.0,
                              fold: bool = True, consts=None) -> Outputs:
    """One fused SQP trip at the candidate (xa + alpha dxc, us + alpha duc):
    the contract of the JAX ``sqp_qp_solve_onepass_cand`` (x0s [12, B] the
    raw initial states; dx0 is formed here; ``fold`` as in
    ``sqp_qp_solve_onepass``)."""
    del fold
    if _dispatch(xa):
        return _k3a_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc,
                         duc, alpha, x0s, mu_b, theta_b, reg, consts=consts)
    return sqp_qp_solve_onepass_cand_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa,
                                         us, xra, dxc, duc, alpha, x0s, mu_b,
                                         theta_b, reg)


def _k4_constants(params, Q_w, Qf_w, R_w, Ac, bc, dev) -> torch.Tensor:
    """K4's constants block: K5's (``srbd_linearize.kernel_constants``),
    which K4a hands K5's launches, then Qf (``csrc/sqp_twopass.cu``
    reads the same layout)."""
    k = torch.cat([srbd_linearize.kernel_constants(params, Q_w, R_w, Ac, bc)
                   .to(dev), Qf_w.to(device=dev, dtype=torch.float32)
                   .reshape(-1)])
    assert k.numel() == _K4_LEN
    return k.contiguous()


def _k4a_launches(consts, xa, us, xra, mu_b, theta_b, reg, stream):
    """K4a as four launches, each return code checked as it is made: K5's
    stage pass and dense write (A, B, R_eff, b, q, r_eff and the merit rows
    [N, 8, B] straight into the buffers below), the terminal-and-merit
    pass (qN into row N of q [N+1, 12, B]; theta, phi, max|defect|, min
    constraint), K6a's team pass also writing Acl and bcl (Q, Qf from the
    constants block, q's N+1 rows its q)."""
    N, Bt = us.shape[0], xa.shape[-1]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xa.device)

    q = empty(N + 1, NX, Bt)
    A, Bm, b, _, reff, Reff, mer = srbd_linearize._launch(
        consts, xa[:N], xa[1:], us, xra[:N], mu_b, theta_b, q=q)
    out4 = empty(4, Bt)                       # theta, phi, maxdef, mincon
    _check(_fn("sqp_twopass", "srbd_k4s_merit_launch", 9,
               [ctypes.c_int] * 2 + [ctypes.c_void_p])(
        consts.data_ptr(), xa.data_ptr(), xra.data_ptr(), mer.data_ptr(),
        q.data_ptr(), *(out4[i].data_ptr() for i in range(4)), N, Bt, stream),
        "sqp_qp_backward terminal and merit pass")
    del mer
    Acl, K = empty(N, NX, NX, Bt), empty(N, NU, NX, Bt)
    bcl, kv = empty(N, NX, Bt), empty(N, NU, Bt)
    q_w = consts[srbd_linearize._K_Q:srbd_linearize._K_LEN]
    qf_w = consts[srbd_linearize._K_LEN:]
    _check(_fn("riccati", "srbd_riccati_bwd_team_acl_launch", 12,
               [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])(
        A.data_ptr(), Bm.data_ptr(), b.data_ptr(), q_w.data_ptr(),
        qf_w.data_ptr(), Reff.data_ptr(), q.data_ptr(), reff.data_ptr(),
        K.data_ptr(), kv.data_ptr(), Acl.data_ptr(), bcl.data_ptr(), N, Bt,
        float(reg), stream),
        "sqp_qp_backward Riccati pass (K6a with Acl, bcl)")
    return Acl, K, bcl, kv, q[:N], reff, q[N], tuple(out4.unbind(0))


def _k4a_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, mu_b, theta_b,
              reg=0.0):
    """K4a on the card (the four launches of ``_k4a_launches``), for the
    card tests and chip_smoke.py. CUDA tensors only; the constants block is
    built once per call."""
    N = us.shape[0]
    Bt = xa.shape[-1]
    for name, t, shape in (("xa", xa, (N + 1, NX, Bt)), ("us", us, (N, NU, Bt)),
                           ("xra", xra, (N + 1, NX, Bt))):
        check_cuda_f32(name, t, shape)
    if tuple(Ac.shape) != (NG, NU):
        raise ValueError(f"Ac: expected shape {(NG, NU)}, got {tuple(Ac.shape)}")
    dev = xa.device
    consts = _k4_constants(params, Q_w, Qf_w, R_w, Ac, bc, dev)
    xa, us, xra = (t.contiguous() for t in (xa, us, xra))
    out = _k4a_launches(consts, xa, us, xra, mu_b, theta_b, reg, _stream(dev))
    launches["sqp_twopass_bwd"] += 1
    return out


def sqp_qp_backward(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra,
                    mu_b: float, theta_b: float, reg: float = 0.0):
    """K4a: the plain version on CPU tensors, the CUDA kernels (f32, the
    four launches of ``_k4a_launches``) on CUDA tensors. Returns as
    ``sqp_qp_backward_ref``."""
    if not _dispatch(xa):
        return sqp_qp_backward_ref(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra,
                                   mu_b, theta_b, reg)
    return _k4a_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, mu_b,
                     theta_b, reg)


def sqp_qp_forward(Acl, K, bcl, kv, q, reff, qN, dx0):
    """K4b: the plain version on CPU tensors, the CUDA kernel (f32) on CUDA
    tensors. Returns as ``sqp_qp_forward_ref``."""
    if not _dispatch(Acl):
        return sqp_qp_forward_ref(Acl, K, bcl, kv, q, reff, qN, dx0)
    N, Bt = Acl.shape[0], Acl.shape[-1]
    for name, t, shape in (("Acl", Acl, (N, NX, NX, Bt)),
                           ("K", K, (N, NU, NX, Bt)), ("bcl", bcl, (N, NX, Bt)),
                           ("kv", kv, (N, NU, Bt)), ("q", q, (N, NX, Bt)),
                           ("reff", reff, (N, NU, Bt)), ("qN", qN, (NX, Bt)),
                           ("dx0", dx0, (NX, Bt))):
        check_cuda_f32(name, t, shape)
    Acl, K, bcl, kv, q, reff, qN, dx0 = (
        t.contiguous() for t in (Acl, K, bcl, kv, q, reff, qN, dx0))
    dev = Acl.device
    dx = torch.empty((N, NX, Bt), dtype=torch.float32, device=dev)
    du = torch.empty((N, NU, Bt), dtype=torch.float32, device=dev)
    dphi = torch.empty((Bt,), dtype=torch.float32, device=dev)
    fn = _fn("sqp_twopass", "srbd_sqp_twopass_fwd_launch", 11,
             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _check(fn(Acl.data_ptr(), K.data_ptr(), bcl.data_ptr(), kv.data_ptr(),
              q.data_ptr(), reff.data_ptr(), qN.data_ptr(), dx0.data_ptr(),
              dx.data_ptr(), du.data_ptr(), dphi.data_ptr(), N, Bt, THREADS,
              _stream(dev)),
           "sqp_twopass forward")
    launches["sqp_twopass_fwd"] += 1
    return dx, du, dphi


def sqp_qp_solve(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dx0,
                 mu_b: float, theta_b: float, reg: float = 0.0) -> Outputs:
    """Two-pass fused SQP QP solve (K4a, then K4b): the contract of the JAX
    ``sqp_qp_solve`` at any width B."""
    *prods, aux = sqp_qp_backward(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra,
                                  mu_b, theta_b, reg)
    dx_rest, du, dphi = sqp_qp_forward(*prods, dx0)
    return torch.cat([dx0[None], dx_rest]), du, dphi, aux
