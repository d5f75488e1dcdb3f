"""The batched merit (kernels K7a and K7b of the port).

Counterpart of ``srbd_nmpc_tpu/models/merit_pallas.py``. theta is the
shooting-defect norm (four-call RK4), phi the tracking, barrier and input
cost plus the terminal cost, both accumulated stage by stage.

- K7a, ``merit_alpha`` (``merit_alpha_pallas``, Pallas ``_kernel_alpha``):
  (theta, phi) at the line-search candidate ``(x + alpha dx, u + alpha du)``
  with a per-scenario alpha, so the backtracking line search never stores
  candidate trajectories. On the card two launches: a stage pass (a thread
  per stage and lane) and a reduction in stage order.
- K7b, ``merit`` (``merit_pallas``, Pallas ``_kernel`` / ``_kernel_nograd``):
  (theta, phi), the diagnostics max|defect| and min constraint and, with
  ``with_grad``, the gradients Jphi_x, Jphi_u at the iterate (x, u).

Each has a plain PyTorch version (``*_ref``, any device and dtype). The
public entries run it on CPU tensors; on CUDA tensors they launch the
hand-written kernel ``csrc/merit.cu`` (f32 only) or raise.
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

# launches of each CUDA kernel since the last reset (read by chip_smoke.py):
# K7a, and K7b with and without gradients
launches = {"merit_alpha": 0, "merit": 0, "merit_nograd": 0}


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


def merit_ref(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, x, u, xr,
              mu_b: float, theta_b: float, with_grad: bool = True):
    """Plain PyTorch version of K7b. x/xr [N+1,12,B], u [N,12,B]; returns
    (theta [B], phi [B], Jphi_x [N+1,12,B], Jphi_u [N,12,B], max|defect| [B],
    min constraint [B]), the gradients None without ``with_grad``. The
    stage sums run in the kernel's order: theta and phi from stage 0 up,
    max|defect| seeded 0, min constraint seeded 1e30, and the terminal
    1/2 e_N' Qf e_N added to phi last."""
    dtype = x.dtype
    xc = x.permute(1, 0, 2)                            # [12, N+1, B]
    uc = u.permute(1, 0, 2)                            # [12, N, B]
    xs, xn = xc[:, :-1], xc[:, 1:]
    nb = (1, 1)

    defect = xn - srbd_soa.rk4(params, xs, uc)         # [12, N, B]
    theta_part = 0.5 * sm.sum_rows(defect * defect)    # [N, B]
    e = xs - xr[:-1].permute(1, 0, 2)
    Qx = sm.mv(Q_w.to(dtype).reshape(Q_w.shape + nb), e)
    phi_x = 0.5 * sm.sum_rows(e * Qx)
    Ac_b = Ac.to(dtype)[:, :, None, None]
    con = sm.mv(Ac_b, uc) + bc.to(dtype)[:, None, None]   # [24, N, B]
    b_bar, db, _ = relaxed_log_barrier(con, mu_b, theta_b)
    Ru = sm.mv(R_w.to(dtype).reshape(R_w.shape + nb), uc)
    phi_u = sm.sum_rows(b_bar) + 0.5 * sm.sum_rows(uc * Ru)
    md_s = defect.abs().amax(dim=0)                    # [N, B]
    mc_s = con.amin(dim=0)

    th, ph = theta_part[0], phi_x[0] + phi_u[0]
    md = torch.maximum(torch.zeros_like(th), md_s[0])
    mc = torch.minimum(torch.full_like(th, 1e30), mc_s[0])
    for g in range(1, theta_part.shape[0]):
        th = th + theta_part[g]
        ph = (ph + phi_x[g]) + phi_u[g]
        md = torch.maximum(md, md_s[g])
        mc = torch.minimum(mc, mc_s[g])
    phi = ph + _half_quad(Qf_w, xc[:, -1] - xr[-1])
    if not with_grad:
        return th, phi, None, None, md, mc
    Jx = torch.cat([Qx.permute(1, 0, 2), _terminal_grad(Qf_w, x, xr)[None]])
    Ju = (sm.mtv(Ac_b, db) + Ru).permute(1, 0, 2)
    return th, phi, Jx, Ju, md, mc


def _terminal_grad(Qf_w, x, xr) -> torch.Tensor:
    """Jphi_x[N] = Qf e_N [12, B] (computed outside the kernel, as JAX does)."""
    return sm.mv(Qf_w.to(x.dtype)[:, :, None], x[-1] - xr[-1])


def _fn(entry: str, argtypes):
    fn = getattr(load_kernel("merit"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _fn("srbd_merit_alpha_launch",
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
               + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _lib_merit():
    return _fn("srbd_merit_launch",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
               + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _merit_alpha_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                      alpha, mu_b, theta_b, consts=None):
    """K7a on the card: the stage pass and the reduction. ``consts``: the
    block of ``kernel_constants`` (built on each call when not given). CUDA
    tensors only."""
    Np1, _, Bt = x.shape
    N = Np1 - 1
    for name, t, shape in (("x", x, (Np1, NX, Bt)), ("xr", xr, (Np1, NX, Bt)),
                           ("dx", dx, (Np1, NX, Bt)), ("u", u, (N, NU, Bt)),
                           ("du", du, (N, NU, Bt)), ("alpha", alpha, (Bt,))):
        check_cuda_f32(name, t, shape)
    if consts is None:
        consts = kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc)
    consts = consts.to(x.device)      # a no-op where the block lies there
    check_cuda_f32("consts", consts, (_K_LEN,))
    x, dx, u, du, xr, alpha = (t.contiguous()
                               for t in (x, dx, u, du, xr, alpha))
    out = torch.empty((2, Bt), dtype=torch.float32, device=x.device)
    terms = torch.empty((3 * N + 1, Bt), dtype=torch.float32,
                        device=x.device)
    err = _lib()(consts.data_ptr(), x.data_ptr(), dx.data_ptr(),
                 u.data_ptr(), du.data_ptr(), xr.data_ptr(), alpha.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), terms.data_ptr(), N, Bt,
                 float(mu_b), float(theta_b), THREADS,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merit kernel launch failed: CUDA error {err}")
    launches["merit_alpha"] += 1
    return out[0], out[1]


def merit_alpha(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                alpha, mu_b: float, theta_b: float, consts=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merit (theta, phi) at the candidate (x + alpha dx, u + alpha du): the
    contract of the JAX ``merit_alpha_pallas`` (any width B). CPU tensors
    run the plain version; CUDA tensors run the CUDA kernels (f32) or
    raise. ``consts``: the kernels' constants block from
    ``kernel_constants`` on the card, built once per solve by the caller
    (built on each CUDA call when not given; the plain version does not
    read it)."""
    if x.device.type == "cuda":
        return _merit_alpha_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx,
                                 du, alpha, mu_b, theta_b, consts=consts)
    if x.device.type != "cpu":
        raise TypeError(f"unsupported device {x.device}")
    return merit_alpha_ref(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, dx, du,
                           alpha, mu_b, theta_b)


def _merit_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, mu_b, theta_b,
                with_grad):
    Np1, _, Bt = x.shape
    N = Np1 - 1
    for name, t, shape in (("x", x, (Np1, NX, Bt)), ("xr", xr, (Np1, NX, Bt)),
                           ("u", u, (N, NU, Bt))):
        check_cuda_f32(name, t, shape)
    consts = kernel_constants(params, Q_w, Qf_w, R_w, Ac, bc).to(x.device)
    x, u, xr = (t.contiguous() for t in (x, u, xr))
    dev = x.device
    out = torch.empty((4, Bt), dtype=torch.float32, device=dev)
    Jx = Ju = None
    if with_grad:
        Jx = torch.empty((Np1, NX, Bt), dtype=torch.float32, device=dev)
        Ju = torch.empty((N, NU, Bt), dtype=torch.float32, device=dev)
    err = _lib_merit()(consts.data_ptr(), x.data_ptr(), u.data_ptr(),
                       xr.data_ptr(), out.data_ptr(),
                       Jx.data_ptr() if with_grad else None,
                       Ju.data_ptr() if with_grad else None, N, Bt,
                       float(mu_b), float(theta_b), int(with_grad), THREADS,
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merit kernel launch failed: CUDA error {err}")
    launches["merit" if with_grad else "merit_nograd"] += 1
    if with_grad:
        # the kernel wrote the N running rows; the terminal row is Qf e_N
        Jx[N] = _terminal_grad(Qf_w, x, xr)
    return out[0], out[1], Jx, Ju, out[2], out[3]


def merit(params: SRBDParams, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, mu_b: float,
          theta_b: float, with_grad: bool = True):
    """Merit with diagnostics and, with ``with_grad``, gradients: the
    contract of the JAX ``merit_pallas`` (any width B). x/xr [N+1,12,B],
    u [N,12,B]; returns (theta, phi, Jphi_x [N+1,12,B], Jphi_u [N,12,B],
    max|defect|, min constraint), the gradients None without
    ``with_grad``. CPU tensors run the plain version; CUDA tensors run the
    CUDA kernel's variant (f32) or raise."""
    if x.device.type == "cuda":
        return _merit_cuda(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, mu_b,
                           theta_b, with_grad)
    if x.device.type != "cpu":
        raise TypeError(f"unsupported device {x.device}")
    return merit_ref(params, Q_w, Qf_w, R_w, Ac, bc, x, u, xr, mu_b, theta_b,
                     with_grad)
