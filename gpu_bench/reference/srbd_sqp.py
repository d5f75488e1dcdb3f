"""Plain PyTorch reference of the batched SRBD NMPC solve.

The yardstick that decides a run's ``correct``: the single-rigid-body model,
its Euler linearization, the relaxed-barrier input cost, a textbook batched
Riccati recursion, the merit, and the SQP loop with the backtracking filter
line search, its iteration cap and its statuses (the SRBD-NMPC-Solver
reference, ``SRBD_model.cpp:75-181`` and ``NMPC_solver.cpp:143-314``).

Scenarios lead every tensor (``x [S, N+1, 12]``, ``u [S, N, 12]``) and every
matrix product goes through ``mm``. The control run (``problem(...,
tf32=True)``) rounds each product's operands to TF32 (10 mantissa bits)
and accumulates in float32, as the card's TF32 mode does, on any device.
Each scenario's answer depends on its own inputs only: the loop is
iteration-synchronous, and a scenario that has stopped is frozen. It
imports nothing of the program under test and takes nothing it made:
every constant is built here from the configuration.
"""

from __future__ import annotations

import contextlib

import torch

NX = 12
NU = 12
NG = 24
GRAVITY = -9.8

SUCCESS, MAX_ITER, MIN_STEP, NAN_DETECTED = 0, 1, 2, 3


def _theta_min(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-4


def problem(config: dict, dtype, device, tf32: bool = False) -> dict:
    """The model, cost and solver constants of ``config`` as tensors;
    ``tf32``: the control's products (float32 only)."""
    if tf32 and dtype != torch.float32:
        raise ValueError("the TF32 control computes in float32")
    m, o, s = config["model"], config["mpc"], config["solver"]

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    N = o["horizon_MPC"]
    mu, lfx, lfz = m["friction_mu"], m["foot_lx"], m["foot_lz"]
    Ac = torch.zeros((NG, NU), dtype=dtype, device=device)
    for leg in range(2):
        rows = [[-1, 0, mu], [0, -1, mu], [1, 0, mu], [0, 1, mu],
                [0, 0, -1], [0, 0, 1], [0, 0, lfx], [0, 0, lfx],
                [0, 0, lfz], [0, 0, lfz]]
        for i, row in enumerate(rows):
            Ac[12 * leg + i, 6 * leg:6 * leg + 3] = t(row)
        tau = {6: [0, -1, 0], 7: [0, 1, 0], 8: [0, 0, -1], 9: [0, 0, 1],
               10: [-1, 0, 0], 11: [1, 0, 0]}
        for i, row in tau.items():
            Ac[12 * leg + i, 6 * leg + 3:6 * leg + 6] = t(row)
    bc = torch.zeros(NG, dtype=dtype, device=device)
    bc[4] = bc[16] = m["fmax"]
    bc[5] = bc[17] = -m["fmin"]
    return dict(
        tf32=tf32, N=N, max_iter=o["sqp_max_loop"], mu_b=o["mu_b"],
        theta_b=o["theta_b"],
        mass=t(m["mass"]), Iinv=torch.diag(1.0 / t(o["Lbody"])),
        feet=t([m["foot_right"], m["foot_left"]]), dt=t(o["dt_MPC"]),
        Ac=Ac, bc=bc, Q=torch.diag(t(o["Q"])), R=o["R"] * torch.eye(
            NU, dtype=dtype, device=device), Qf=N * torch.diag(t(o["Qf"])),
        x_ref=t(config["problem"]["x_ref"]), **{k: s[k] for k in (
            "theta_max", "theta_min", "eta", "beta_phi", "beta_theta",
            "beta_alpha", "alpha_min", "reg", "conv_dphi", "conv_theta")})


# ---- model -------------------------------------------------------------

def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _round_tf32(t):
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(P, a, b):
    """a @ b, with TF32 operands in the control run."""
    if P["tf32"]:
        a, b = _round_tf32(a), _round_tf32(b)
    return a @ b


def _mv(P, M, v):
    return mm(P, M, v.unsqueeze(-1)).squeeze(-1)


def _so3(P, r, derivative: bool):
    """expm(r), the left Jacobian Jl, its inverse Jlt and, with
    ``derivative``, d Jlt / d r_a for a = 0, 1, 2."""
    h = _theta_min(r.dtype)
    t = torch.sqrt(torch.clamp_min((r * r).sum(-1), h * h))[..., None, None]
    st, ct = torch.sin(t), torch.cos(t)
    W = _skew(r)
    WW = mm(P, W, W)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    sinc = st / t
    R = eye + sinc * W + ((1.0 - ct) / (t * t)) * WW
    V, VV = W / t, WW / (t * t)
    half = 0.5 * t
    hc = half * torch.cos(half) / torch.sin(half)
    Jlt = hc * eye + (1.0 - hc) * (VV + eye) - half * V
    if not derivative:
        return R, Jlt
    Jl = sinc * eye + (1.0 - sinc) * (VV + eye) + ((1.0 - ct) / t) * V
    t3 = t * t * t
    base = ((t * st + 2.0 * (ct - 1.0)) / t3) * V - (
        (2.0 * t - 3.0 * st + t * ct) / t3) * VV
    c1, c2 = (t - st) / t3, (1.0 - ct) / (t * t)
    dJlt = []
    for a in range(3):
        E = _skew(eye[a]).expand(W.shape)
        dJl = c1 * (mm(P, E, W) + mm(P, W, E)) + c2 * E + r[
            ..., a, None, None] * base
        dJlt.append(-mm(P, mm(P, Jlt, dJl), Jlt))
    return R, Jlt, Jl, dJlt


def dynamics(P, x, u):
    """dx/dt of the SRBD model, x and u [..., 12]."""
    r, l, p = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    R, Jlt = _so3(P, r, False)
    w = _mv(P, mm(P, mm(P, R, P["Iinv"]), R.mT), l)
    F_r, F_l = u[..., 0:3], u[..., 6:9]
    l_dot = (u[..., 3:6] + u[..., 9:12]
             + torch.linalg.cross(P["feet"][0] - p, F_r)
             + torch.linalg.cross(P["feet"][1] - p, F_l))
    g = torch.zeros(3, dtype=x.dtype, device=x.device)
    g[2] = GRAVITY
    return torch.cat([_mv(P, Jlt, w), l_dot, x[..., 9:12],
                      (F_r + F_l) / P["mass"] + g], -1)


def rk4(P, x, u):
    dt = P["dt"]
    k1 = dynamics(P, x, u)
    k2 = dynamics(P, x + 0.5 * dt * k1, u)
    k3 = dynamics(P, x + 0.5 * dt * k2, u)
    k4 = dynamics(P, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def euler_ab(P, x, u):
    """Euler sensitivities A = I + dt df/dx, B = dt df/du, [..., 12, 12]."""
    r, l, p = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    R, Jlt, Jl, dJlt = _so3(P, r, True)
    RIRt = mm(P, mm(P, R, P["Iinv"]), R.mT)
    w = _mv(P, RIRt, l)
    D1 = torch.stack([_mv(P, d, w) for d in dJlt], -1) + mm(
        P, mm(P, Jlt, mm(P, RIRt, _skew(l)) - _skew(w)), Jl)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device).expand(D1.shape)
    fx = torch.zeros(x.shape[:-1] + (NX, NX), dtype=x.dtype, device=x.device)
    fu = torch.zeros_like(fx)
    fx[..., 0:3, 0:3] = D1
    fx[..., 0:3, 3:6] = mm(P, Jlt, RIRt)
    fx[..., 3:6, 6:9] = _skew(u[..., 0:3] + u[..., 6:9])
    fx[..., 6:9, 9:12] = eye3
    fu[..., 3:6, 0:3] = _skew(P["feet"][0] - p)
    fu[..., 3:6, 3:6] = eye3
    fu[..., 3:6, 6:9] = _skew(P["feet"][1] - p)
    fu[..., 3:6, 9:12] = eye3
    fu[..., 9:12, 0:3] = eye3 / P["mass"]
    fu[..., 9:12, 6:9] = eye3 / P["mass"]
    eye12 = torch.eye(NX, dtype=x.dtype, device=x.device)
    return eye12 + P["dt"] * fx, P["dt"] * fu


def barrier(v, mu, th):
    """Relaxed log barrier and its first two derivatives, elementwise."""
    log_side = v > th
    vs = torch.where(log_side, v, torch.full_like(v, th))
    z = (v - 2.0 * th) / th
    b = torch.where(log_side, -mu * torch.log(vs),
                    0.5 * mu * (z * z - 1.0) - mu * torch.log(
                        torch.full_like(v, th)))
    db = torch.where(log_side, -mu / vs, mu * (v - 2.0 * th) / (th * th))
    ddb = torch.where(log_side, mu / (vs * vs),
                      torch.full_like(v, mu / (th * th)))
    return b, db, ddb


# ---- merit, linearization, QP ----------------------------------------------

def _cost(P, x, u):
    """phi: tracking, terminal, barrier and input cost, per scenario."""
    ex = x - P["x_ref"]
    con = mm(P, u, P["Ac"].mT) + P["bc"]
    b, _, _ = barrier(con, P["mu_b"], P["theta_b"])
    Ru = mm(P, u, P["R"])
    return (0.5 * (ex[:, :-1] * mm(P, ex[:, :-1], P["Q"])).sum((1, 2))
            + 0.5 * (ex[:, -1] * mm(P, ex[:, -1], P["Qf"])).sum(1)
            + b.sum((1, 2)) + 0.5 * (u * Ru).sum((1, 2)))


def merit(P, x, u):
    """(theta, phi): half the squared shooting defects, and the cost."""
    d = x[:, 1:] - rk4(P, x[:, :-1], u)
    return 0.5 * (d * d).sum((1, 2)), _cost(P, x, u)


def linearize(P, x, u):
    """The delta-form QP around (x, u) and the merit there."""
    xs = x[:, :-1]
    A, Bm = euler_ab(P, xs, u)
    b = rk4(P, xs, u) - x[:, 1:]
    con = mm(P, u, P["Ac"].mT) + P["bc"]
    _, db, ddb = barrier(con, P["mu_b"], P["theta_b"])
    Ac = P["Ac"]
    R_eff = P["R"] + mm(P, Ac.mT, ddb[..., None] * Ac)
    r = mm(P, u, P["R"]) + mm(P, db, Ac)
    ex = x - P["x_ref"]
    q = torch.cat([mm(P, ex[:, :-1], P["Q"]),
                   mm(P, ex[:, -1], P["Qf"])[:, None]], 1)
    theta = 0.5 * (b * b).sum((1, 2))
    return A, Bm, b, R_eff, q, r, theta, _cost(P, x, u)


def _chol_solve(L, rhs):
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def riccati(P, A, Bm, b, R_eff, q, r, dx0):
    """Backward Riccati recursion and forward rollout of the QP; returns
    (dx [S, N+1, 12], du [S, N, 12]). A G that is not positive definite
    gives NaN, which the merit turns into NAN_DETECTED."""
    N = A.shape[1]
    regI = P["reg"] * torch.eye(NU, dtype=A.dtype, device=A.device)
    Pn, pn = P["Qf"].expand(A.shape[0], NX, NX), q[:, N]
    K, k = [None] * N, [None] * N
    for i in reversed(range(N)):
        Ai, Bi = A[:, i], Bm[:, i]
        PA = mm(P, Pn, Ai)
        G = R_eff[:, i] + mm(P, Bi.mT, mm(P, Pn, Bi)) + regI
        G = 0.5 * (G + G.mT)
        H = mm(P, Bi.mT, PA)
        L, info = torch.linalg.cholesky_ex(G)
        L = L.masked_fill((info != 0)[:, None, None], float("nan"))
        Pb_p = _mv(P, Pn, b[:, i]) + pn
        sol = _chol_solve(L, torch.cat(
            [H, (_mv(P, Bi.mT, Pb_p) + r[:, i])[..., None]], -1))
        K[i], k[i] = -sol[..., :NX], -sol[..., NX]
        Pi = P["Q"] + mm(P, Ai.mT, PA) + mm(P, H.mT, K[i])
        pn = q[:, i] + _mv(P, Ai.mT, Pb_p) + _mv(P, H.mT, k[i])
        Pn = 0.5 * (Pi + Pi.mT)
    dx, du = [dx0], []
    for i in range(N):
        du.append(_mv(P, K[i], dx[-1]) + k[i])
        dx.append(_mv(P, A[:, i], dx[-1]) + _mv(P, Bm[:, i], du[-1])
                  + b[:, i])
    return torch.stack(dx, 1), torch.stack(du, 1)


def _accept(P, th_a, ph_a, alpha, th0, ph0, dphi):
    """The filter's three cases (NMPC_solver.cpp:200-264)."""
    infeasible = th_a > P["theta_max"]
    small = (torch.maximum(th_a, th0) < P["theta_min"]) & (dphi < 0.0)
    return torch.where(
        infeasible, th_a < (1.0 - P["beta_theta"]) * th0,
        torch.where(small, ph_a < ph0 + P["eta"] * alpha * dphi,
                    (ph_a < ph0 - P["beta_phi"] * th0)
                    | (th_a < (1.0 - P["beta_theta"]) * th0)))


# ---- the solve -------------------------------------------------------------

def solve(P, x, u, alpha, x0):
    """SQP from the iterate (x, u, alpha) with initial states ``x0
    [S, 12]``: returns (x, u, status, sqp_iters, converged). Each
    iteration linearizes, solves the QP, tests convergence (dphi > conv_dphi
    and theta < conv_theta) and runs the line search to its end from the
    persistent step length; a scenario stops at SUCCESS or NAN_DETECTED, or
    after ``max_iter`` iterations (MAX_ITER, or MIN_STEP where the step
    length fell to alpha_min)."""
    S = x.shape[0]
    dev = x.device
    status = torch.full((S,), MAX_ITER, dtype=torch.int32, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    alpha = alpha.clone()
    for _ in range(P["max_iter"]):
        act = status == MAX_ITER
        if not bool(act.any()):
            break
        A, Bm, b, R_eff, q, r, th0, ph0 = linearize(P, x, u)
        dx, du = riccati(P, A, Bm, b, R_eff, q, r, x0 - x[:, 0])
        dphi = (dx * q).sum((1, 2)) + (du * r).sum((1, 2))
        nan = ~torch.isfinite(th0 + ph0 + dphi)
        conv = (dphi > P["conv_dphi"]) & (th0 < P["conv_theta"])
        acc = torch.zeros(S, dtype=torch.bool, device=dev)
        a = alpha
        while True:
            searching = act & ~nan & ~acc & (a > P["alpha_min"])
            if not bool(searching.any()):
                break
            aa = a[:, None, None]
            th_a, ph_a = merit(P, x + aa * dx, u + aa * du)
            ok = _accept(P, th_a, ph_a, a, th0, ph0, dphi) & searching
            a = torch.where(searching & ~ok, P["beta_alpha"] * a, a)
            acc = acc | ok
        step = (acc & act)[:, None, None]
        aa = a[:, None, None]
        x = torch.where(step, x + aa * dx, x)
        u = torch.where(step, u + aa * du, u)
        alpha = torch.where(act, a, alpha)
        iters = iters + act.to(torch.int32)
        status = torch.where(act & conv, SUCCESS, torch.where(
            act & nan, NAN_DETECTED, status)).to(torch.int32)
    stalled = (status == MAX_ITER) & (alpha <= P["alpha_min"])
    status = torch.where(stalled, MIN_STEP, status).to(torch.int32)
    return x, u, status, iters, status == SUCCESS


@contextlib.contextmanager
def full_precision():
    """float32 matrix products in full precision (TF32 off) while the
    reference runs; the settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
