"""Stage linearization of the SRBD NMPC (kernel K5 of the port).

Counterpart of ``srbd_nmpc_tpu/models/srbd_pallas.py`` (``linearize_pallas``
and its Pallas kernel ``_kernel``): per stage and scenario, the whole
prepareQpStructures stage math (NMPC_solver.cpp:276-314), i.e. the Euler
sensitivities (A, B), the RK4 shooting defect b, the barrier-augmented input
cost (R_eff, r_eff), the tracking gradient q, and eight merit partials.

- ``linearize_ref``: the plain PyTorch version, any device and dtype
  (``models.srbd_soa`` and ``ops.smallmat`` k-loops).
- ``linearize``: the public entry. CPU tensors run the plain version; CUDA
  tensors launch the hand-written kernels of ``csrc/linearize.cu`` (f32
  only), the stage pass and the block-written dense A, B, R_eff, or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd_soa
from srbd_nmpc_tpu_torch.models.srbd import NG, NU, NX, SRBDParams
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.utils.build import check_cuda_f32, load_kernel

# constants block handed to the kernel (offsets match csrc/linearize.cu)
_K_AC, _K_BC, _K_R, _K_Q, _K_LEN = 17, 305, 329, 473, 617
# the words a stage pass hands to the dense write (csrc/linearize.cu H_C):
# ddb, one per constraint row
_HAND = 24

# launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0


def model_constants(params: SRBDParams) -> torch.Tensor:
    """mass, dt, inverse inertia (row-major) and foot positions: the first
    17 entries of every SRBD kernel's constants block (``srbd_dev.cuh``
    ``load_model``)."""
    return torch.cat([params.mass.reshape(1), params.dt.reshape(1),
                      params.inertia_inv.reshape(9),
                      params.foot_pos.reshape(6)])


def kernel_constants(params: SRBDParams, Q_w, R_w, Ac, bc) -> torch.Tensor:
    """The kernel's float32 constants block at the ``_K_*`` offsets."""
    k = torch.cat([model_constants(params), Ac.reshape(NG * NU),
                   bc.reshape(NG), R_w.reshape(NU * NU),
                   Q_w.reshape(NX * NX)]).to(torch.float32).contiguous()
    assert k.numel() == _K_LEN
    return k


def linearize_ref(params: SRBDParams, Q_w, R_w, Ac, bc, xs, xn, us, xr,
                  mu_b: float, theta_b: float, jac=srbd_soa.euler_AB
                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K5. Inputs stage-major [N, 12, B]: state,
    next state, input and reference per stage. Returns (A, B
    [N,12,12,B], b, q, r_eff [N,12,B], R_eff [N,12,12,B], mer [N,8,B]);
    ``mer`` rows: 1/2 sum b^2, sum barrier, min constraint, max |b|,
    1/2 u'Ru, 1/2 ex'q, 0, 0. ``jac(params, x, u)`` gives (A, B)
    [12, 12, N, B] from x, u [12, N, B]: the Euler sensitivities (K5's)
    by default; the ``xla`` route passes the exact ones."""
    dtype = xs.dtype
    x, x_next, u, x_r = (t.permute(1, 0, 2) for t in (xs, xn, us, xr))
    A, Bm = jac(params, x, u)                          # [12, 12, N, B]
    b = srbd_soa.rk4(params, x, u) - x_next            # [12, N, B]

    Ac_b = Ac.to(dtype)[:, :, None, None]
    con = sm.mv(Ac_b, u) + bc.to(dtype)[:, None, None]  # [24, N, B]
    b_bar, db, ddb = relaxed_log_barrier(con, mu_b, theta_b)
    Rw = R_w.to(dtype)[:, :, None, None]
    R_eff = Rw + sm.mtm(Ac_b, Ac_b * ddb[:, None])
    Ru = sm.mv(Rw, u)
    r_eff = Ru + sm.mtv(Ac_b, db)
    ex = x - x_r
    q = sm.mv(Q_w.to(dtype)[:, :, None, None], ex)

    zero = torch.zeros_like(b[0])
    mer = torch.stack([
        0.5 * sm.sum_rows(b * b), sm.sum_rows(b_bar), con.amin(dim=0),
        b.abs().amax(dim=0), 0.5 * sm.sum_rows(u * Ru),
        0.5 * sm.sum_rows(ex * q), zero, zero])          # [8, N, B]

    def mats(t):
        return t.permute(2, 0, 1, 3).contiguous()

    def vecs(t):
        return t.permute(1, 0, 2).contiguous()

    return (mats(A), mats(Bm), vecs(b), vecs(q), vecs(r_eff), mats(R_eff),
            vecs(mer))


def _lib():
    fn = load_kernel("linearize").srbd_linearize_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(consts, xs, xn, us, xr, mu_b, theta_b, one_thread=False, q=None):
    """K5's launch (``csrc/linearize.cu``), its return code checked; counts
    nothing. ``consts``: the block of ``kernel_constants``, or a longer block
    that starts with it (K4a's). ``q``: a buffer whose first N rows take q
    (K4a's [N+1, 12, B], whose row N its terminal pass fills), else one of N
    rows. Returns A, B, b, q (N rows), r_eff, R_eff and the merit rows."""
    N, _, Bt = xs.shape
    check_cuda_f32("consts", consts[:_K_LEN], (_K_LEN,))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xs.device)

    A, Bm, R_eff = (empty(N, NX, NX, Bt), empty(N, NX, NU, Bt),
                    empty(N, NU, NU, Bt))
    b, r_eff, mer = empty(N, NX, Bt), empty(N, NU, Bt), empty(N, 8, Bt)
    q = empty(N, NX, Bt) if q is None else q
    hand = None if one_thread else empty(N, _HAND, Bt)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = _lib()(int(one_thread), consts.data_ptr(), xs.data_ptr(),
                 xn.data_ptr(), us.data_ptr(), xr.data_ptr(), A.data_ptr(),
                 Bm.data_ptr(),
                 b.data_ptr(), R_eff.data_ptr(), r_eff.data_ptr(),
                 q.data_ptr(), mer.data_ptr(),
                 None if hand is None else hand.data_ptr(), N, Bt,
                 float(mu_b), float(theta_b), stream)
    if err != 0:
        raise RuntimeError(f"linearize kernel launch failed: CUDA error {err}")
    return A, Bm, b, q[:N], r_eff, R_eff, mer


def _linearize_cuda(params, Q_w, R_w, Ac, bc, xs, xn, us, xr, mu_b, theta_b,
                    one_thread=False, consts=None):
    """K5 on the card: the stage pass and the dense write (two launches
    through a [N, 24, B] hand-off), or with ``one_thread`` the one-thread
    kernel ``linearize_kernel``, the yardstick that the card tests and
    chip_smoke.py hold to the plain version and time the new design
    against. ``consts``: the block of ``kernel_constants`` (built on each
    call when not given). CUDA tensors only."""
    global launches
    N, _, Bt = xs.shape
    for name, t in (("xs", xs), ("xn", xn), ("us", us), ("xr", xr)):
        check_cuda_f32(name, t, (N, NX, Bt))
    if consts is None:
        consts = kernel_constants(params, Q_w, R_w, Ac, bc)
    consts = consts.to(xs.device)     # a no-op where the block lies there
    check_cuda_f32("consts", consts, (_K_LEN,))
    xs, xn, us, xr = (t.contiguous() for t in (xs, xn, us, xr))
    out = _launch(consts, xs, xn, us, xr, mu_b, theta_b, one_thread)
    launches += 1
    return out


def linearize(params: SRBDParams, Q_w, R_w, Ac, bc, xs, xn, us, xr,
              mu_b: float, theta_b: float, consts=None
              ) -> Tuple[torch.Tensor, ...]:
    """Fused stage linearization: the contract of the JAX
    ``linearize_pallas`` (any width B). CPU tensors run the plain version;
    CUDA tensors run the CUDA kernels (f32) or raise. ``consts``: the
    kernels' constants block from ``kernel_constants`` on the card, built
    once per solve by the caller (built on each CUDA call when not
    given; the plain version does not read it)."""
    if xs.device.type == "cuda":
        return _linearize_cuda(params, Q_w, R_w, Ac, bc, xs, xn, us, xr,
                               mu_b, theta_b, consts=consts)
    if xs.device.type != "cpu":
        raise TypeError(f"unsupported device {xs.device}")
    return linearize_ref(params, Q_w, R_w, Ac, bc, xs, xn, us, xr, mu_b,
                         theta_b)
