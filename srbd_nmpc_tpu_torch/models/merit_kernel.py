"""Merit (theta, phi) at a line-search candidate (kernel K7a of the port).

Counterpart of ``srbd_nmpc_tpu/models/merit_pallas.py`` (``merit_alpha_pallas``
and its Pallas kernel ``_kernel_alpha``): the merit at the candidate
``(x + alpha dx, u + alpha du)`` with a per-scenario alpha, so the
backtracking line search never stores candidate trajectories. theta is the
shooting-defect norm (four-call RK4), phi the tracking, barrier and input
cost plus the terminal cost, both accumulated stage by stage.

- ``merit_alpha_ref``: the plain PyTorch version, any device and dtype.
- ``merit_alpha``: the public entry. CPU tensors run the plain version;
  CUDA tensors launch the hand-written kernel ``csrc/merit.cu`` (f32 only)
  or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.models import srbd_soa
from srbd_nmpc_tpu_torch.models.srbd import NG, NU, NX, SRBDParams
from srbd_nmpc_tpu_torch.models.srbd_linearize import model_constants
from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.ops.barrier import relaxed_log_barrier
from srbd_nmpc_tpu_torch.utils.build import check_cuda_f32, load_kernel

# constants block handed to the kernel (offsets match csrc/merit.cu)
_K_LEN = 761
THREADS = 128

# launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0


def _half_quad(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """1/2 v' M v over the leading axis of v [12, ...], for M [12, 12]."""
    nb = (1,) * (v.dim() - 1)
    return 0.5 * sm.sum_rows(v * sm.mv(M.to(v.dtype).reshape(M.shape + nb), v))


def merit_alpha_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx,
                    du, alpha, mu_b: float, theta_b: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7a. x/xr/dx [N+1,12,B], u/du [N,12,B],
    alpha [B]; returns (theta [B], phi [B])."""
    dtype = x.dtype
    a = alpha[None, None, :]
    xc = (x + a * dx).permute(1, 0, 2)                 # [12, N+1, B]
    uc = (u + a * du).permute(1, 0, 2)                 # [12, N, B]
    xs, xn = xc[:, :-1], xc[:, 1:]

    defect = xn - srbd_soa.rk4(params, xs, uc)
    theta_part = 0.5 * sm.sum_rows(defect * defect)    # [N, B]
    phi_x = _half_quad(Q_w, xs - xr[:-1].permute(1, 0, 2))
    Ac_b = Ac.to(dtype)[:, :, None, None]
    con = sm.mv(Ac_b, uc) + bc.to(dtype)[:, None, None]
    b_bar, _, _ = relaxed_log_barrier(con, mu_b, theta_b)
    phi_u = sm.sum_rows(b_bar) + _half_quad(R_w, uc)

    th, ph = theta_part[0], phi_x[0] + phi_u[0]
    for g in range(1, theta_part.shape[0]):
        th = th + theta_part[g]
        ph = (ph + phi_x[g]) + phi_u[g]
    return th, ph + _half_quad(Qf_w, xc[:, -1] - xr[-1])


def kernel_constants(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc
                     ) -> torch.Tensor:
    """The kernel's float32 constants block (``_K_LEN`` entries)."""
    k = torch.cat([model_constants(params), Ac.reshape(NG * NU),
                   bc.reshape(NG), R_w.reshape(-1), Q_w.reshape(-1),
                   Qf_w.reshape(-1)]).to(torch.float32).contiguous()
    assert k.numel() == _K_LEN
    return k


def _lib():
    fn = load_kernel("merit").srbd_merit_alpha_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _merit_alpha_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                      alpha, mu_b, theta_b):
    global launches
    Np1, _, Bt = x.shape
    N = Np1 - 1
    for name, t, shape in (("x", x, (Np1, NX, Bt)), ("xr", xr, (Np1, NX, Bt)),
                           ("dx", dx, (Np1, NX, Bt)), ("u", u, (N, NU, Bt)),
                           ("du", du, (N, NU, Bt)), ("alpha", alpha, (Bt,))):
        check_cuda_f32(name, t, shape)
    consts = kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc).to(x.device)
    x, dx, u, du, xr, alpha = (t.contiguous()
                               for t in (x, dx, u, du, xr, alpha))
    out = torch.empty((2, Bt), dtype=torch.float32, device=x.device)
    err = _lib()(consts.data_ptr(), x.data_ptr(), dx.data_ptr(), u.data_ptr(),
                 du.data_ptr(), xr.data_ptr(), alpha.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), N, Bt, float(mu_b),
                 float(theta_b), THREADS,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merit kernel launch failed: CUDA error {err}")
    launches += 1
    return out[0], out[1]


def merit_alpha(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                alpha, mu_b: float, theta_b: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merit (theta, phi) at the candidate (x + alpha dx, u + alpha du): the
    contract of the JAX ``merit_alpha_pallas`` (any width B). CPU tensors
    run the plain version; CUDA tensors run the CUDA kernel (f32) or
    raise."""
    if x.device.type == "cuda":
        return _merit_alpha_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx,
                                 du, alpha, mu_b, theta_b)
    if x.device.type != "cpu":
        raise TypeError(f"unsupported device {x.device}")
    return merit_alpha_ref(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                           alpha, mu_b, theta_b)
