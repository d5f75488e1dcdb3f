"""One fused SQP trip at a candidate point: plane-phase linearization,
structured backward Riccati, forward rollout and directional derivative.

Counterpart of ``srbd_nmpc_tpu/ops/sqp_planes.py`` (kernel
``_onepass_planes_kernel`` with ``_planes_phase`` and its three stage
bodies: ``sqp_pallas._riccati_stage_structured`` parking the gains, the
same stage parking its factor (``factor=True``), and
``_riccati_stage_rank6`` (``rank6=True``)), the kernel K1 of the port.

- ``sqp_qp_solve_onepass_planes_ref``: the plain PyTorch version, any
  device and dtype. Per-scenario arithmetic never crosses lanes, and every
  reduction over stages or rows is an explicit loop, so a lane's result
  does not depend on the batch width.
- ``sqp_qp_solve_onepass_planes``: the public entry. CPU tensors go to the
  plain version; CUDA tensors launch the hand-written kernels (f32 only) or
  raise: each of the three bodies as three launches of
  ``csrc/sqp_planes_split.cu`` (a plane pass, a Riccati pass with a team
  of 16 threads per scenario, the rollout; the rank-6 body's Riccati pass
  is its rank-6 form, the factor body's Riccati pass and rollout their
  factor forms). The one-thread kernels of ``csrc/sqp_planes.cu`` stay as
  yardsticks, reached only through the private ``_gains_cuda``,
  ``_rank6_cuda`` and ``_factor_cuda(one_thread=True)``.

The candidate fold ``x + alpha dx`` is applied on load, so one function
serves the bootstrap (alpha = 0) and every speculative line-search trip.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd_planes as spl
from srbd_nmpc_tpu_torch.models import srbd_soa
from srbd_nmpc_tpu_torch.models.srbd import NG, NU, NX, SRBDParams
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.ops.sqp_stage import (_jxt, _jxtv,
                                               _riccati_stage_structured,
                                               _split_leg_blocks,
                                               kernel_constants,
                                               r_leg_diagonal)
from srbd_nmpc_tpu_torch.utils.build import check_cuda_f32, load_kernel

# pack channel layout (C rows per stage), as in the JAX kernel
_D1 = 0          # 9: D1 row-major
_D2 = 9          # 9: D2 row-major
_SF = 18         # 3: generator of SF = skew(f01 + f02)
_SR = 21         # 3: generator of Sr = skew(pf0 - p)
_SL = 24         # 3: generator of Sl = skew(pf1 - p)
_B = 27          # 12: defect b = rk4(x, u) - x_next
_Q = 39          # 12: q = Qw (x - xr)
_RF = 51         # 12: r_eff = Rw u + Ac' db
_DDB = 63        # 24: barrier curvature ddb
_C = 87

# CUDA threads per block of K1's one-launch bodies (independent of
# NmpcConfig.pallas_block, which only sets the granularity of the compaction
# tiers)
THREADS = 128

# the split bodies' scratch beside the pack: per stage the merit terms
# u_i (R u)_i, e_i (Q e)_i (12 each), the barrier sum and the least
# constraint; the terminal stage's qN and eN'qN
_M_C = 26
_T_C = 13

# calls of each stage body on the card since the last reset (read by
# chip_smoke.py); a call counts once, whichever kernels run it
launches = {"gains": 0, "rank6": 0, "factor": 0}


def _planes_phase(params, Q_w, Qf_w, R_w, Ac1, Ac2, bc, xa, us, xra, dxc,
                  duc, alpha, mu_b, theta_b):
    """Linearize all stages on [N, B] planes; return the merit outputs,
    the structured pack [C, N, B] and the terminal (P, p) seed."""
    N = us.shape[0]
    Bt = xa.shape[-1]
    dtype, dev = xa.dtype, xa.device

    x_p = tuple(xa[0:N, e] + alpha * dxc[0:N, e] for e in range(NX))
    xn_p = tuple(xa[1:N + 1, e] + alpha * dxc[1:N + 1, e] for e in range(NX))
    u_p = tuple(us[:, e] + alpha * duc[:, e] for e in range(NU))
    e_p = tuple(x_p[e] - xra[0:N, e] for e in range(NX))

    mass, dt = params.mass, params.dt
    iv = params.inertia_inv.to(dtype)
    Iinv = tuple(tuple(iv[i, j] for j in range(3)) for i in range(3))
    ft = params.foot_pos.to(dtype)
    pf0 = tuple(ft[0, j] for j in range(3))
    pf1 = tuple(ft[1, j] for j in range(3))

    D1, D2, sF, sr, sl, x_next = spl.linearize_stage(
        mass, dt, Iinv, pf0, pf1, x_p, u_p)
    b_p = tuple(x_next[e] - xn_p[e] for e in range(NX))

    # ---- constraints + barrier on the [NG, N, B] stack ---------------------
    con_p = [spl._addn(*(Ac1[g, j] * u_p[j] for j in range(6)), bc[g])
             for g in range(12)]
    con_p += [spl._addn(*(Ac2[g, j] * u_p[6 + j] for j in range(6)),
                        bc[12 + g]) for g in range(12)]
    CON = torch.stack(con_p)
    b_bar, db, ddb = relaxed_log_barrier(CON, mu_b, theta_b)

    q_p = tuple(spl._addn(*(Q_w[i, j] * e_p[j] for j in range(NX)))
                for i in range(NX))
    Ru_p = tuple(spl._addn(*(R_w[i, j] * u_p[j] for j in range(NU)))
                 for i in range(NU))
    reff_p = [Ru_p[i] + spl._addn(*(Ac1[g, i] * db[g] for g in range(12)))
              for i in range(6)]
    reff_p += [Ru_p[6 + i] + spl._addn(*(Ac2[g, i] * db[12 + g]
                                         for g in range(12)))
               for i in range(6)]

    # ---- terminal stage + Riccati seed -------------------------------------
    eN = xa[N] + alpha * dxc[N] - xra[N]
    Qf_b = Qf_w[:, :, None].expand(NX, NX, Bt)
    qN = sm.mv(Qf_b, eN)

    # ---- merit reductions across stages ------------------------------------
    theta = 0.5 * spl._addn(*(sm.sum_rows(b_p[e] * b_p[e]) for e in range(NX)))
    maxdef = b_p[0].abs().amax(dim=0)
    for e in range(1, NX):
        maxdef = torch.maximum(maxdef, b_p[e].abs().amax(dim=0))
    phiN = 0.5 * sm.sum_rows(eN * qN)
    phi = (sm.sum_rows(sm.sum_rows(b_bar))
           + 0.5 * spl._addn(*(sm.sum_rows(u_p[i] * Ru_p[i])
                               for i in range(NU)))
           + 0.5 * spl._addn(*(sm.sum_rows(e_p[i] * q_p[i])
                               for i in range(NX)))
           + phiN)
    mincon = CON.amin(dim=(0, 1))

    def plane(v):
        if isinstance(v, (int, float)):
            return torch.full((N, Bt), v, dtype=dtype, device=dev)
        return v

    planes = ([plane(D1[i][j]) for i in range(3) for j in range(3)]
              + [plane(D2[i][j]) for i in range(3) for j in range(3)]
              + [plane(v) for v in sF] + [plane(v) for v in sr]
              + [plane(v) for v in sl]
              + [plane(v) for v in b_p] + [plane(v) for v in q_p]
              + [plane(v) for v in reff_p])
    pack = torch.cat([torch.stack(planes), ddb], dim=0)   # [C, N, B]
    return (theta, phi, maxdef, mincon), pack, Qf_b, qN


def _riccati_stage_rank6(dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, R1h, R2h,
                         reff, q, b, P, p):
    """The structured backward-Riccati stage through rank(B) = 6 (JAX
    ``sqp_planes._riccati_stage_rank6``, the same operations in the same
    order). The control Jacobian has six nonzero rows (row-blocks 1 and 3:
    W = [[Sr, I, Sl, I], [I/m, 0, I/m, 0]]), so with R^ = Reff + reg I
    leg-block-diagonal (R1h, R2h [6, 6, B]) and Pss the [6, 6] block of P
    on those rows, G^-1 W' = R^-1 W' M6^-1 with M6 = I + dt^2 Pss T,
    T = W R^-1 W'. M6 is solved symmetrically: T = Lt Lt',
    w = (I + dt^2 Lt' Pss Lt)^-1 Lt' y, x = y - dt^2 Pss Lt w. Four SPD 6x6
    factorizations (R1h, R2h, T, Ms) replace the 12x12 Cholesky and its
    13-column solve. Returns (P_new, p_new, K, kv)."""
    dtype, dev = P.dtype, P.device
    Bt = P.shape[-1]
    dt2 = dt * dt

    V = _jxt(D1, D2, SF, P)                            # Jx' P
    M = V.transpose(0, 1)                              # P Jx  (P = P')
    PA = P + dt * M

    def srows(X):
        return torch.cat([X[3:6], X[9:12]], dim=0)

    Y = srows(PA)                                      # [6, 12, B]
    Pb_p = sm.mv(P, b) + p
    ys = srows(Pb_p)                                   # [6, B]
    Ps = srows(P)
    Pss = torch.cat([Ps[:, 3:6], Ps[:, 9:12]], dim=1)  # [6, 6, B]

    # W' column blocks: C1 = [[Sr', I/m], [I, 0]], C2 = [[Sl', I/m], [I, 0]]
    z3 = torch.zeros((3, 3, Bt), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)[:, :, None].expand(3, 3, Bt)
    Im3 = m_inv * I3
    C1 = torch.cat([torch.cat([Sr.transpose(0, 1), Im3], dim=1),
                    torch.cat([I3, z3], dim=1)], dim=0)
    C2 = torch.cat([torch.cat([Sl.transpose(0, 1), Im3], dim=1),
                    torch.cat([I3, z3], dim=1)], dim=0)

    L1, d1 = sm.cholesky(R1h)
    L2, d2 = sm.cholesky(R2h)
    E1 = sm.chol_solve(L1, d1, C1)                     # R^-1 W' top
    E2 = sm.chol_solve(L2, d2, C2)                     # R^-1 W' bottom
    T = sm.mtm(C1, E1) + sm.mtm(C2, E2)                # W R^-1 W'  [6, 6]
    Lt, _ = sm.cholesky(T)
    PssLt = sm.mm(Pss, Lt)
    Ms = sm.add_diag(dt2 * sm.mtm(Lt, PssLt), 1.0)     # I + dt^2 Lt'Pss Lt
    Lm, dm = sm.cholesky(Ms)

    # r~ = R^-1 reff (block-diagonal solve), w_r = W r~
    rt1 = sm.chol_solve_vec(L1, d1, reff[0:6])
    rt2 = sm.chol_solve_vec(L2, d2, reff[6:12])
    w_r = sm.mtv(C1, rt1) + sm.mtv(C2, rt2)
    zvec = dt * ys - dt2 * sm.mv(Pss, w_r)

    # M6^-1 applied to [Y | zvec] through the symmetric inner system
    RHS = torch.cat([Y, zvec[:, None]], dim=1)         # [6, 13, B]
    w = sm.chol_solve(Lm, dm, sm.mtm(Lt, RHS))
    X = RHS - dt2 * sm.mm(Pss, sm.mm(Lt, w))
    Yh = X[:, 0:12]                                    # M6^-1 Y
    zh = X[:, 12]

    # K = -dt R^-1 W' Yh; kv = -(r~ + R^-1 W' zh)
    K = -dt * torch.cat([sm.mm(E1, Yh), sm.mm(E2, Yh)], dim=0)
    kv = -torch.cat([rt1 + sm.mv(E1, zh), rt2 + sm.mv(E2, zh)], dim=0)

    # H'K = dt Y'(W K) with W K = -dt T Yh; H'kv = dt Y'(W kv),
    # W kv = -(w_r + T zh)
    WK = -dt * sm.mm(T, Yh)
    HtK = dt * sm.mtm(Y, WK)
    Wkv = -(w_r + sm.mv(T, zh))
    Htkv = dt * sm.mtv(Y, Wkv)

    P_new = Qw_b + P + dt * (M + V) + dt2 * _jxt(D1, D2, SF, M) + HtK
    P_new = 0.5 * (P_new + P_new.transpose(0, 1))
    p_new = q + Pb_p + dt * _jxtv(D1, D2, SF, Pb_p) + Htkv
    return P_new, p_new, K, kv


def _body(rank6: bool, factor: bool, rank6_ok) -> str:
    """The stage body a call runs: ``"gains"`` (the 12x12 stage, parking
    K and kv), ``"rank6"`` or ``"factor"``. ``rank6_ok()`` says whether R_w
    is leg-block-diagonal: where it is not, ``rank6`` runs the 12x12 stage,
    silently, as the JAX kernel does."""
    if factor and rank6:
        raise ValueError("factor=True is not implemented for the rank-6 "
                         "stage (rank6=True)")
    if factor:
        return "factor"
    return "rank6" if rank6 and rank6_ok() else "gains"


def sqp_qp_solve_onepass_planes_ref(
    params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
    alpha, x0s, mu_b: float, theta_b: float, reg: float = 0.0,
    rank6: bool = False, factor: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of K1: the fused SQP QP solve at the candidate
    (xa + alpha dxc, us + alpha duc). Shapes: xa/xra/dxc [N+1, 12, B],
    us/duc [N, 12, B], alpha [B], x0s [12, B]. Returns
    (dx [N+1,12,B], du [N,12,B], dphi [B], (theta, phi, maxdef, mincon)).
    ``rank6`` and ``factor`` pick the stage body as
    ``sqp_qp_solve_onepass_planes`` says."""
    body = _body(rank6, factor, lambda: r_leg_diagonal(R_w))
    N = us.shape[0]
    Bt = xa.shape[-1]
    Ac1, Ac2 = _split_leg_blocks(Ac)
    dt = params.dt
    m_inv = 1.0 / params.mass

    dx0 = x0s - (xa[0] + alpha[None, :] * dxc[0])
    aux, pack, P, p = _planes_phase(params, Q_w, Qf_w, R_w, Ac1, Ac2, bc,
                                    xa, us, xra, dxc, duc, alpha,
                                    mu_b, theta_b)
    qN = p

    def widen(c):
        return c[..., None].expand(c.shape + (Bt,))

    def stage(pk):
        D1 = pk[_D1:_D1 + 9].reshape(3, 3, Bt)
        D2 = pk[_D2:_D2 + 9].reshape(3, 3, Bt)
        return (D1, D2, pk[_SF:_SF + 3], pk[_SR:_SR + 3], pk[_SL:_SL + 3],
                pk[_B:_B + 12], pk[_Q:_Q + 12], pk[_RF:_RF + 12],
                pk[_DDB:_DDB + 24])

    Ac1_b, Ac2_b, Rw_b, Qw_b = widen(Ac1), widen(Ac2), widen(R_w), widen(Q_w)
    z66 = torch.zeros((6, 6, Bt), dtype=xa.dtype, device=xa.device)
    # per stage: (K, kv), or (L, dinv, Yh, yv) for the factor body
    parks = [None] * N
    for k in reversed(range(N)):
        D1, D2, sF, sr, sl, b, q, reff, ddb = stage(pack[:, k])
        SF, Sr, Sl = srbd_soa.skew(sF), srbd_soa.skew(sr), srbd_soa.skew(sl)
        C11 = sm.mtm(Ac1_b, Ac1_b * ddb[0:12, None])
        C22 = sm.mtm(Ac2_b, Ac2_b * ddb[12:24, None])
        if body == "rank6":
            R1h = sm.add_diag(Rw_b[0:6, 0:6] + C11, reg)
            R2h = sm.add_diag(Rw_b[6:12, 6:12] + C22, reg)
            P, p, K, kv = _riccati_stage_rank6(
                dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, R1h, R2h, reff, q, b,
                P, p)
            parks[k] = (K, kv)
            continue
        Reff = Rw_b + torch.cat([torch.cat([C11, z66], dim=1),
                                 torch.cat([z66, C22], dim=1)], dim=0)
        out = _riccati_stage_structured(
            dt, m_inv, D1, D2, SF, Sr, Sl, Qw_b, Reff, reff, q, b, P, p, reg,
            with_acl=False, return_factor=body == "factor")
        P, p = out[0], out[1]
        parks[k] = out[2:] if body == "factor" else (out[3], out[5])

    # forward rollout: dx_{k+1} = dx + dt (Jx dx + Ju du) + b, block-wise
    dx = dx0
    dxs, dus = [dx0], []
    tot = None
    for k in range(N):
        D1, D2, sF, sr, sl, b, q, reff, _ = stage(pack[:, k])
        if body == "factor":
            L, dinv, Yh, yv = parks[k]
            t = sm.mv(Yh, dx) + yv
            du = -sm.bwd_subst(L, dinv, t[:, None]).squeeze(1)
        else:
            K, kv = parks[k]
            du = sm.mv(K, dx) + kv
        d0, d1, d2, d3 = dx[0:3], dx[3:6], dx[6:9], dx[9:12]
        u0, u1, u2, u3 = du[0:3], du[3:6], du[6:9], du[9:12]
        dxn = dx + b + dt * torch.cat([
            sm.mv(D1, d0) + sm.mv(D2, d1),
            srbd_soa.cross(sF, d2) + srbd_soa.cross(sr, u0) + u1
            + srbd_soa.cross(sl, u2) + u3,
            d3,
            m_inv * (u0 + u2)], dim=0)
        part = sm.sum_rows(dx * q) + sm.sum_rows(du * reff)
        tot = part if tot is None else tot + part
        dus.append(du)
        dxs.append(dxn)
        dx = dxn
    dphi = tot + sm.sum_rows(dx * qN)
    return torch.stack(dxs), torch.stack(dus), dphi, aux


# the stage bodies, in the order of the C entries' ``body`` argument
BODIES = ("gains", "rank6", "factor")


def park_shapes(body: str, N: int, B: int):
    """Shapes of the kernel's four park arrays for ``body``: K [N,12,12,B]
    and kv [N,12,B]; for the factor body Yh and yv in their place, the
    lower triangle of L [N,78,B] and dinv [N,12,B] (None: not used)."""
    if body == "factor":
        return ((N, NU, NX, B), (N, NU, B), (N, NU * (NU + 1) // 2, B),
                (N, NU, B))
    return ((N, NU, NX, B), (N, NU, B), None, None)


def _lib():
    fn = load_kernel("sqp_planes").srbd_sqp_planes_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 20
                       + [ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _split_lib():
    lib = load_kernel("sqp_planes_split")
    if lib.srbd_k1s_planes_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.srbd_k1s_planes_launch.argtypes = [P] * 10 + [I, I, F, F, P]
        lib.srbd_k1s_riccati_launch.argtypes = [P] * 5 + [I, I, F, P]
        lib.srbd_k1s_rollout_launch.argtypes = [P] * 14 + [I, I, P]
        lib.srbd_k1s_riccati_factor_launch.argtypes = [P] * 7 + [I, I, F, P]
        lib.srbd_k1s_rollout_factor_launch.argtypes = [P] * 16 + [I, I, P]
        lib.srbd_k1s_riccati_rank6_launch.argtypes = [P] * 5 + [I, I, F, P]
        for fn in (lib.srbd_k1s_planes_launch, lib.srbd_k1s_riccati_launch,
                   lib.srbd_k1s_rollout_launch,
                   lib.srbd_k1s_riccati_factor_launch,
                   lib.srbd_k1s_rollout_factor_launch,
                   lib.srbd_k1s_riccati_rank6_launch):
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def riccati_team_cuda(kc, pack, term, reg, stream):
    """K1s-B, ``k1s_riccati_team_kernel`` (``csrc/sqp_planes_split.cu``):
    the structured backward Riccati pass over a pack [N, 87, B] (``_D1`` ...
    ``_DDB``), seeded by P = Qf and p = ``term[:12]``, a team of 16 threads
    per scenario. Returns the parked K [N,12,12,B] and kv [N,12,B]. The
    split gains body and K3's split trip (``ops/sqp_kernel``) both run it."""
    N, Bt = pack.shape[0], pack.shape[-1]
    park0, park1 = (torch.empty(s, dtype=torch.float32, device=pack.device)
                    for s in park_shapes("gains", N, Bt)[:2])
    _check("sqp_planes_split Riccati pass",
           _split_lib().srbd_k1s_riccati_launch(
               kc.data_ptr(), pack.data_ptr(), term.data_ptr(),
               park0.data_ptr(), park1.data_ptr(), N, Bt, float(reg), stream))
    return park0, park1


def _launch_split(body, kc, xa, us, xra, dxc, duc, alpha, dx, du, out5,
                  mu_b, theta_b, reg, stream):
    """``body`` as three launches (``csrc/sqp_planes_split.cu``): the plane
    pass, the Riccati pass, the rollout (for the rank-6 body the rank-6 form
    of the Riccati pass; for the factor body the factor forms of the last
    two, which park and back-substitute the stage factor); each
    launch's return code checked as it is made."""
    N, Bt = us.shape[0], xa.shape[-1]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xa.device)

    pack, mer, term = empty(N, _C, Bt), empty(N, _M_C, Bt), empty(_T_C, Bt)
    lib = _split_lib()
    _check("sqp_planes_split plane pass", lib.srbd_k1s_planes_launch(
        kc.data_ptr(), xa.data_ptr(), us.data_ptr(), xra.data_ptr(),
        dxc.data_ptr(), duc.data_ptr(), alpha.data_ptr(), pack.data_ptr(),
        mer.data_ptr(), term.data_ptr(), N, Bt, float(mu_b), float(theta_b),
        stream))
    rollout = lib.srbd_k1s_rollout_launch
    if body == "gains":
        parks = riccati_team_cuda(kc, pack, term, reg, stream)
    elif body == "rank6":
        parks = [empty(*s) for s in park_shapes("rank6", N, Bt)[:2]]
        _check("sqp_planes_split rank-6 Riccati pass",
               lib.srbd_k1s_riccati_rank6_launch(
                   kc.data_ptr(), pack.data_ptr(), term.data_ptr(),
                   *(p.data_ptr() for p in parks), N, Bt, float(reg),
                   stream))
    else:
        parks = [empty(*s) for s in park_shapes("factor", N, Bt)]
        _check("sqp_planes_split factor Riccati pass",
               lib.srbd_k1s_riccati_factor_launch(
                   kc.data_ptr(), pack.data_ptr(), term.data_ptr(),
                   *(p.data_ptr() for p in parks), N, Bt, float(reg),
                   stream))
        rollout = lib.srbd_k1s_rollout_factor_launch
    _check(f"sqp_planes_split rollout ({body})", rollout(
        kc.data_ptr(), pack.data_ptr(), mer.data_ptr(), term.data_ptr(),
        *(p.data_ptr() for p in parks), dx.data_ptr(), dx[1:].data_ptr(),
        du.data_ptr(), *(out5[i].data_ptr() for i in range(5)), N, Bt,
        stream))


def _solve_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                alpha, x0s, mu_b, theta_b, reg, rank6, factor, consts,
                one_thread=False):
    N = us.shape[0]
    Bt = xa.shape[-1]
    for name, t, shape in (("xa", xa, (N + 1, NX, Bt)),
                           ("us", us, (N, NU, Bt)),
                           ("xra", xra, (N + 1, NX, Bt)),
                           ("dxc", dxc, (N + 1, NX, Bt)),
                           ("duc", duc, (N, NU, Bt)),
                           ("alpha", alpha, (Bt,)),
                           ("x0s", x0s, (NX, Bt))):
        check_cuda_f32(name, t, shape)
    if consts is None:
        consts = kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc)
    body = _body(rank6, factor, lambda: consts.rank6)
    xa, us, xra, dxc, duc, alpha, x0s = (
        t.contiguous() for t in (xa, us, xra, dxc, duc, alpha, x0s))

    dev = xa.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = empty(N + 1, NX, Bt)
    dx[0] = x0s - (xa[0] + alpha[None, :] * dxc[0])
    du = empty(N, NU, Bt)
    out5 = empty(5, Bt)                       # dphi, theta, phi, md, mc
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not one_thread:
        _launch_split(body, consts.block, xa, us, xra, dxc, duc, alpha, dx,
                      du, out5, mu_b, theta_b, reg, stream)
    else:
        pack = empty(N, _C, Bt)
        parks = [empty(*s) if s else None for s in park_shapes(body, N, Bt)]
        _check(f"sqp_planes kernel ({body})", _lib()(
            BODIES.index(body), consts.block.data_ptr(), xa.data_ptr(),
            us.data_ptr(), xra.data_ptr(), dxc.data_ptr(), duc.data_ptr(),
            alpha.data_ptr(), dx.data_ptr(), dx[1:].data_ptr(),
            du.data_ptr(), *(out5[i].data_ptr() for i in range(5)),
            pack.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in parks),
            N, Bt, float(mu_b), float(theta_b), float(reg), THREADS, stream))
    launches[body] += 1
    return dx, du, out5[0], (out5[1], out5[2], out5[3], out5[4])


def _gains_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                alpha, x0s, mu_b, theta_b, reg=0.0, one_thread=False,
                consts=None):
    """The gains body on the card: the split kernels, or with
    ``one_thread`` the one-thread kernel ``sqp_planes.cu <kGains>``, the
    yardstick that the card tests and chip_smoke.py hold to the plain
    version and time the split kernels against. CUDA tensors only."""
    return _solve_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                       alpha, x0s, mu_b, theta_b, reg, False, False, consts,
                       one_thread=one_thread)


def _rank6_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                alpha, x0s, mu_b, theta_b, reg=0.0, one_thread=False,
                consts=None):
    """``rank6=True`` on the card, as ``_gains_cuda`` the gains body: the
    split kernels, or with ``one_thread`` the yardstick
    ``sqp_planes.cu <kRank6>``. ``consts.rank6`` decides the body, as on
    the public entry. CUDA tensors only."""
    return _solve_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                       alpha, x0s, mu_b, theta_b, reg, True, False, consts,
                       one_thread=one_thread)


def _factor_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                 alpha, x0s, mu_b, theta_b, reg=0.0, one_thread=False,
                 consts=None):
    """The factor body on the card, as ``_gains_cuda`` the gains body: the
    split kernels, or with ``one_thread`` the yardstick
    ``sqp_planes.cu <kFactor>``. CUDA tensors only."""
    return _solve_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
                       alpha, x0s, mu_b, theta_b, reg, False, True, consts,
                       one_thread=one_thread)


def sqp_qp_solve_onepass_planes(
    params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc,
    alpha, x0s, mu_b: float, theta_b: float, reg: float = 0.0,
    rank6: bool = False, factor: bool = False, consts=None,
):
    """Fused SQP QP solve at the candidate (xa + alpha dxc, us + alpha duc);
    the contract of the JAX ``sqp_qp_solve_onepass_planes``. CPU tensors
    run the plain version; CUDA tensors run the CUDA kernel (f32) or
    raise. Requires ``Ac`` leg-block-diagonal (checked). ``consts``: the
    kernel's constants from ``sqp_stage.kernel_constants`` (built, with its
    checks, on each CUDA call when not given).

    The stage body (JAX's three):

    - default: the 12x12 structured stage, parking the gains (K, kv); on
      CUDA the three launches of ``sqp_planes_split.cu``;
    - ``rank6``: the rank-6 stage (``_riccati_stage_rank6``). It needs R_w
      leg-block-diagonal; where it is not, the 12x12 stage runs, silently,
      as in JAX (on CUDA ``consts.rank6`` decides, with no read-back; the
      launch counter says which body ran). On CUDA the three launches of
      ``sqp_planes_split.cu`` with the rank-6 form of its Riccati pass;
    - ``factor``: the 12x12 stage parking its factor (L, dinv) and
      forward-substituted half (Yh, yv); the rollout forms
      du = -L'^-1 (Yh dx + yv) per stage. On CUDA the three launches of
      ``sqp_planes_split.cu`` with the factor forms of its Riccati pass and
      rollout.

    ``factor`` with ``rank6`` raises ``ValueError``, as in JAX. JAX's
    ``factor`` limit on its lane block (``block <= 128``) guards the TPU's
    VMEM and has no counterpart: the CUDA kernels park in global memory,
    and their block sizes are fixed."""
    if xa.device.type == "cuda":
        return _solve_cuda(params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc,
                           duc, alpha, x0s, mu_b, theta_b, reg, rank6, factor,
                           consts)
    if xa.device.type != "cpu":
        raise TypeError(f"unsupported device {xa.device}")
    return sqp_qp_solve_onepass_planes_ref(
        params, Q_w, Qf_w, R_w, Ac, bc, xa, us, xra, dxc, duc, alpha, x0s,
        mu_b, theta_b, reg, rank6=rank6, factor=factor)
