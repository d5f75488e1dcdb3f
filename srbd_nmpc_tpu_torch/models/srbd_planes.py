"""SRBD dynamics and Jacobian blocks as entry-wise algebra over stage planes.

Counterpart of ``srbd_nmpc_tpu/models/srbd_planes.py`` (one association
differs: ``linearize_stage`` applies the SO(3) derivative term to w as
K1's kernel does, so that K1 rounds as this plain version). Every per-stage
scalar is a plane ``[N, B]`` (all stages of all scenarios), 3-vectors and
3x3 matrices are Python tuples of planes, and entries may also be Python
float constants: ``_mul``/``_add`` fold structural zeros and ones before
any tensor op runs, so skew matrices and the 0/+-1 basis skews cost only
their nonzero terms, with the same expression forms as the JAX twin.
"""

from __future__ import annotations

import torch

from srbd_nmpc_tpu_torch.models.srbd import GRAVITY
from srbd_nmpc_tpu_torch.ops.so3 import _theta_min

# ---------------------------------------------------------------------------
# zero/one-aware entry arithmetic (entries: tensors or Python floats)
# ---------------------------------------------------------------------------


def _isz(a) -> bool:
    return isinstance(a, (int, float)) and a == 0.0


def _mul(a, b):
    if _isz(a) or _isz(b):
        return 0.0
    if isinstance(a, (int, float)) and a == 1.0:
        return b
    if isinstance(b, (int, float)) and b == 1.0:
        return a
    return a * b


def _add(a, b):
    if _isz(a):
        return b
    if _isz(b):
        return a
    return a + b


def _sub(a, b):
    if _isz(b):
        return a
    if _isz(a):
        return -b
    return a - b


def _addn(*terms):
    acc = 0.0
    for t in terms:
        acc = _add(acc, t)
    return acc


# ---------------------------------------------------------------------------
# 3-vector / 3x3-matrix algebra on entry tuples
# ---------------------------------------------------------------------------

I3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def m3(A, B):
    """A @ B."""
    return tuple(
        tuple(_addn(*(_mul(A[i][k], B[k][j]) for k in range(3)))
              for j in range(3))
        for i in range(3))


def m3v(A, v):
    return tuple(_addn(*(_mul(A[i][k], v[k]) for k in range(3)))
                 for i in range(3))


def m3T(A):
    return tuple(tuple(A[j][i] for j in range(3)) for i in range(3))


def m3_add(A, B):
    return tuple(tuple(_add(A[i][j], B[i][j]) for j in range(3))
                 for i in range(3))


def m3_scale(s, A):
    return tuple(tuple(_mul(s, A[i][j]) for j in range(3)) for i in range(3))


def v3_add(a, b):
    return tuple(_add(a[i], b[i]) for i in range(3))


def v3_sub(a, b):
    return tuple(_sub(a[i], b[i]) for i in range(3))


def v3_cross(a, b):
    return (_sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
            _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
            _sub(_mul(a[0], b[1]), _mul(a[1], b[0])))


def skew(v):
    return ((0.0, _mul(-1.0, v[2]), v[1]),
            (v[2], 0.0, _mul(-1.0, v[0])),
            (_mul(-1.0, v[1]), v[0], 0.0))


# constant basis skews E_a = skew(e_a) — 0/+-1 entries fold in _mul
_E = (((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)),
      ((0.0, 0.0, 1.0), (0.0, 0.0, 0.0), (-1.0, 0.0, 0.0)),
      ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 0.0)))


# ---------------------------------------------------------------------------
# SO(3) chain and dynamics
# ---------------------------------------------------------------------------


def _safe_theta(r):
    # the f32 clamp when every entry is a Python constant (no dtype)
    h = _theta_min(torch.float32)
    for e in r:
        if not isinstance(e, (int, float)):
            h = _theta_min(e.dtype)
            break
    sq = _addn(*(_mul(e, e) for e in r))
    return torch.sqrt(torch.clamp_min(sq, h * h))


def so3_chain(r):
    """R, Jl, Jlt, djl (tuple of 3 matrices: d Jl / d r_a)."""
    t = _safe_theta(r)
    st, ct = torch.sin(t), torch.cos(t)
    t2 = t * t
    t3 = t2 * t
    inv_t = 1.0 / t
    W = skew(r)
    WW = m3(W, W)

    sinc = st * inv_t
    R = m3_add(I3, m3_add(m3_scale(sinc, W), m3_scale((1.0 - ct) / t2, WW)))

    V = m3_scale(inv_t, W)
    VV = m3_scale(inv_t * inv_t, WW)
    VVI = m3_add(VV, I3)
    Jl = m3_add(m3_scale(sinc, I3),
                m3_add(m3_scale(1.0 - sinc, VVI),
                       m3_scale((1.0 - ct) * inv_t, V)))
    half_t = 0.5 * t
    hc = half_t * (torch.cos(half_t) / torch.sin(half_t))
    Jlt = m3_add(m3_scale(hc, I3),
                 m3_add(m3_scale(1.0 - hc, VVI), m3_scale(-half_t, V)))

    base = m3_add(
        m3_scale((t * st + 2.0 * (ct - 1.0)) / t3, V),
        m3_scale(-(2.0 * t - 3.0 * st + t * ct) / t3, VV))
    c1 = (t - st) / t3
    c2 = (1.0 - ct) / t2

    djl = tuple(
        m3_add(m3_scale(c1, m3_add(m3(_E[a], W), m3(W, _E[a]))),
               m3_add(m3_scale(c2, _E[a]), m3_scale(r[a], base)))
        for a in range(3))
    return R, Jl, Jlt, djl


def _chain_lite(r):
    """(R, Jlt) with the dynamics' expression forms."""
    t = _safe_theta(r)
    st, ct = torch.sin(t), torch.cos(t)
    inv_t = 1.0 / t
    W = skew(r)
    WW = m3(W, W)
    sinc = st * inv_t
    R = m3_add(I3, m3_add(m3_scale(sinc, W),
                          m3_scale((1.0 - ct) * inv_t * inv_t, WW)))
    VV = m3_scale(inv_t * inv_t, WW)
    VVI = m3_add(VV, I3)
    half_t = 0.5 * t
    hc = half_t * (torch.cos(half_t) / torch.sin(half_t))
    Jlt = m3_add(m3_scale(hc, I3),
                 m3_add(m3_scale(1.0 - hc, VVI),
                        m3_scale(-half_t, m3_scale(inv_t, W))))
    return R, Jlt


def _deriv(mass, Iinv, pf0, pf1, x, u, R, Jlt):
    """dx/dt given the chain quantities; x/u are 12-tuples of planes."""
    l, p, v = x[3:6], x[6:9], x[9:12]
    RIRt = m3(m3(R, Iinv), m3T(R))
    w = m3v(RIRt, l)
    r_dot = m3v(Jlt, w)
    f01, tau0, f02, tau1 = u[0:3], u[3:6], u[6:9], u[9:12]
    l_dot = v3_add(v3_add(tau0, tau1),
                   v3_add(v3_cross(v3_sub(pf0, p), f01),
                          v3_cross(v3_sub(pf1, p), f02)))
    inv_m = 1.0 / mass
    v_dot = (_mul(inv_m, _add(f01[0], f02[0])),
             _mul(inv_m, _add(f01[1], f02[1])),
             _add(_mul(inv_m, _add(f01[2], f02[2])), GRAVITY))
    return tuple(r_dot) + tuple(l_dot) + tuple(v) + tuple(v_dot)


def dynamics(mass, Iinv, pf0, pf1, x, u):
    """12-tuple dx/dt on planes."""
    R, Jlt = _chain_lite(x[0:3])
    return _deriv(mass, Iinv, pf0, pf1, x, u, R, Jlt)


def _axpy(a, x, y):
    """tuple y + a*x entry-wise."""
    return tuple(_add(yi, _mul(a, xi)) for xi, yi in zip(x, y))


def djlt_apply(Jlt, djl_a, w, Jw):
    """(d Jl^-1 / d r_a) w = -Jl^-1 (d Jl / d r_a) Jl^-1 w, with Jw = Jlt w,
    formed from the right: -(Jlt (djl_a Jw)), K1's CUDA association. JAX
    forms the matrix -(Jlt djl_a Jlt) first: the same to rounding, but in
    float32 on an H100 K1's rank-6 body then differed from this plain
    version by 1.6e-4 (parity metric) after the Riccati solve; with K1's
    association the two agree bitwise there. The host build of K1 in
    float32 shows the cause (tests/test_torch_sqp_planes.py::
    test_f32_host_build_rounds_d1_as_plain)."""
    return tuple(_mul(-1.0, z) for z in m3v(Jlt, m3v(djl_a, Jw)))


def linearize_stage(mass, dt, Iinv, pf0, pf1, x, u):
    """(D1, D2, sF, sr, sl, x_next): the Euler Jacobian blocks (D1, D2 as
    3x3 entry matrices; SF/Sr/Sl as the vectors that generate those
    skews) and the RK4 step, sharing one so3 chain, R I^-1 R' and w."""
    l, p, v = x[3:6], x[6:9], x[9:12]
    R, Jl, Jlt, djl = so3_chain(x[0:3])

    RIRt = m3(m3(R, Iinv), m3T(R))
    w = m3v(RIRt, l)
    Jw = m3v(Jlt, w)

    # D1[i][a] = (djlt_a w)[i] + (Jlt (RIRt skew(l) - skew(w)) Jl)[i][a]
    djlt_w = tuple(djlt_apply(Jlt, djl[a], w, Jw) for a in range(3))
    core = m3(Jlt, m3(m3_add(m3(RIRt, skew(l)), m3_scale(-1.0, skew(w))), Jl))
    D1 = tuple(tuple(_add(djlt_w[a][i], core[i][a]) for a in range(3))
               for i in range(3))
    D2 = m3(Jlt, RIRt)
    f01, tau0, f02, tau1 = u[0:3], u[3:6], u[6:9], u[9:12]
    sF = v3_add(f01, f02)
    sr = v3_sub(pf0, p)
    sl = v3_sub(pf1, p)

    # RK4 with k1 from the shared chain
    l_dot = v3_add(v3_add(tau0, tau1),
                   v3_add(v3_cross(sr, f01), v3_cross(sl, f02)))
    inv_m = 1.0 / mass
    v_dot = (_mul(inv_m, _add(f01[0], f02[0])),
             _mul(inv_m, _add(f01[1], f02[1])),
             _add(_mul(inv_m, _add(f01[2], f02[2])), GRAVITY))
    k1 = tuple(Jw) + tuple(l_dot) + tuple(v) + tuple(v_dot)

    k2 = dynamics(mass, Iinv, pf0, pf1, _axpy(0.5 * dt, k1, x), u)
    k3 = dynamics(mass, Iinv, pf0, pf1, _axpy(0.5 * dt, k2, x), u)
    k4 = dynamics(mass, Iinv, pf0, pf1, _axpy(dt, k3, x), u)
    x_next = tuple(
        _add(xi, _mul(dt / 6.0,
                      _addn(k1i, _mul(2.0, k2i), _mul(2.0, k3i), k4i)))
        for xi, k1i, k2i, k3i, k4i in zip(x, k1, k2, k3, k4))
    return D1, D2, sF, sr, sl, x_next
