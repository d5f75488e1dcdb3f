"""Batched LQR solve with S = 0 for the ``pallas`` QP route (kernel K6).

Counterpart of ``srbd_nmpc_tpu/ops/riccati_pallas.py`` (``lqr_solve_pallas``
and its Pallas kernels ``_backward_kernel_constq``, ``_backward_kernel`` and
``_forward_kernel``): the backward Riccati recursion ``(P, p) -> (K, k)``,
then the rollout ``u = K x + k``, ``x' = A x + B u + b``.

The rounding order is the TPU kernel's, not ``ops.riccati_soa``'s:
``G = R + B'PB + reg I`` is not symmetrized before its Cholesky, and P is
symmetrized after each stage.

- ``lqr_backward_ref`` / ``lqr_forward_ref``: the plain PyTorch versions,
  any device and dtype.
- ``lqr_backward`` / ``lqr_forward``: CPU tensors run the plain versions;
  CUDA tensors launch ``csrc/riccati.cu`` (f32 only) or raise. The
  backward pass launches the team kernel ``riccati_team_kernel`` (a team of
  threads per scenario over shared memory).
- ``lqr_solve``: the contract of ``lqr_solve_pallas``.

``Q`` is either a stacked per-stage, per-scenario tensor [N+1,12,12,B] or a
tuple ``(Q, Qf)`` of [12,12] matrices shared by every stage and scenario
(the engine's case); each CUDA backward kernel is one template over both.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from srbd_nmpc_tpu_torch.ops import smallmat as sm
from srbd_nmpc_tpu_torch.utils.build import check_cuda_f32, load_kernel

NX = 12
THREADS = 128

# launches of each CUDA kernel since the last reset (read by chip_smoke.py);
# the backward kernel counts its two instantiations apart
launches = {"riccati_bwd_constq": 0, "riccati_bwd": 0, "riccati_fwd": 0}


def lqr_backward_ref(A, B, b, Q, R, q, r, reg: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward recursion: A, B, R [N,12,12,B], b [N,12,B],
    q [N+1,12,B], Q as in the module docstring. Returns (K [N,12,12,B],
    k [N,12,B])."""
    N, Bt = A.shape[0], A.shape[-1]
    const_q = isinstance(Q, tuple)

    def widen(m):
        return m.to(device=A.device, dtype=A.dtype)[:, :, None].expand(
            NX, NX, Bt)

    P = widen(Q[1]) if const_q else Q[N]
    p = q[N]
    Ks, ks = [None] * N, [None] * N
    for g in reversed(range(N)):
        PA = sm.mm(P, A[g])
        PB = sm.mm(P, B[g])
        G = sm.add_diag(R[g] + sm.mtm(B[g], PB), reg)
        H = sm.mtm(B[g], PA)
        L, dinv = sm.cholesky(G)
        Ks[g] = -sm.chol_solve(L, dinv, H)
        Pb_p = sm.mv(P, b[g]) + p
        ks[g] = -sm.chol_solve_vec(L, dinv, sm.mtv(B[g], Pb_p) + r[g])
        Q_g = widen(Q[0]) if const_q else Q[g]
        P = sm.sym(Q_g + sm.mtm(A[g], PA) + sm.mtm(H, Ks[g]))
        p = q[g] + sm.mtv(A[g], Pb_p) + sm.mtv(H, ks[g])
    return torch.stack(Ks), torch.stack(ks)


def lqr_forward_ref(A, B, b, K, k, x0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain rollout from x0 [12,B]; returns (x [N,12,B] for stages
    1..N, u [N,12,B])."""
    x = x0
    xs, us = [], []
    for g in range(A.shape[0]):
        u = sm.mv(K[g], x) + k[g]
        x = sm.mv(A[g], x) + sm.mv(B[g], u) + b[g]
        us.append(u)
        xs.append(x)
    return torch.stack(xs), torch.stack(us)


def _fn(name: str, nptr: int, tail):
    fn = getattr(load_kernel("riccati"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nptr + tail
        fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _lqr_backward_cuda(A, B, b, Q, R, q, r, reg: float = 0.0):
    """The backward recursion on the card: the team kernel. float32 CUDA
    tensors only."""
    N, Bt = A.shape[0], A.shape[-1]
    const_q = isinstance(Q, tuple)
    shapes = [("A", A, (N, NX, NX, Bt)), ("B", B, (N, NX, NX, Bt)),
              ("R", R, (N, NX, NX, Bt)), ("b", b, (N, NX, Bt)),
              ("q", q, (N + 1, NX, Bt)), ("r", r, (N, NX, Bt))]
    if const_q:
        for name, m in zip(("Q", "Qf"), Q):
            if tuple(m.shape) != (NX, NX):
                raise ValueError(f"{name}: expected shape ({NX}, {NX}), "
                                 f"got {tuple(m.shape)}")
    else:
        shapes.append(("Q", Q, (N + 1, NX, NX, Bt)))
    for name, t, shape in shapes:
        check_cuda_f32(name, t, shape)
    dev = A.device
    if const_q:   # no copy (no device kernel) for float32 matrices on the card
        Qw, Qf = (m.to(device=dev, dtype=torch.float32).contiguous()
                  for m in Q)
    else:
        Qw = Qf = Q.contiguous()
    A, B, b, R, q, r = (t.contiguous() for t in (A, B, b, R, q, r))
    K = torch.empty((N, NX, NX, Bt), dtype=torch.float32, device=dev)
    k = torch.empty((N, NX, Bt), dtype=torch.float32, device=dev)
    tail = [t.data_ptr() for t in (R, q, r, K, k)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _fn("srbd_riccati_bwd_team_launch", 10,
             [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int]
             + [ctypes.c_void_p])
    _check(fn(A.data_ptr(), B.data_ptr(), b.data_ptr(), Qw.data_ptr(),
              Qf.data_ptr(), *tail, N, Bt, float(reg), int(const_q), stream),
           "riccati backward")
    launches["riccati_bwd_constq" if const_q else "riccati_bwd"] += 1
    return K, k


def lqr_backward(A, B, b, Q, R, q, r, reg: float = 0.0):
    """Backward recursion: the plain version on CPU tensors, the team
    kernel (f32) on CUDA tensors."""
    if A.device.type == "cpu":
        return lqr_backward_ref(A, B, b, Q, R, q, r, reg)
    if A.device.type != "cuda":
        raise TypeError(f"unsupported device {A.device}")
    return _lqr_backward_cuda(A, B, b, Q, R, q, r, reg)


def lqr_forward(A, B, b, K, k, x0):
    """Rollout: the plain version on CPU tensors, the CUDA kernel (f32) on
    CUDA tensors."""
    if A.device.type == "cpu":
        return lqr_forward_ref(A, B, b, K, k, x0)
    if A.device.type != "cuda":
        raise TypeError(f"unsupported device {A.device}")
    N, Bt = A.shape[0], A.shape[-1]
    for name, t, shape in (("A", A, (N, NX, NX, Bt)), ("B", B, (N, NX, NX, Bt)),
                           ("K", K, (N, NX, NX, Bt)), ("b", b, (N, NX, Bt)),
                           ("k", k, (N, NX, Bt)), ("x0", x0, (NX, Bt))):
        check_cuda_f32(name, t, shape)
    A, B, b, K, k, x0 = (t.contiguous() for t in (A, B, b, K, k, x0))
    x = torch.empty((N, NX, Bt), dtype=torch.float32, device=A.device)
    u = torch.empty((N, NX, Bt), dtype=torch.float32, device=A.device)
    fn = _fn("srbd_riccati_fwd_launch", 8,
             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _check(fn(A.data_ptr(), B.data_ptr(), b.data_ptr(), K.data_ptr(),
              k.data_ptr(), x0.data_ptr(), x.data_ptr(), u.data_ptr(), N, Bt,
              THREADS, torch.cuda.current_stream(A.device).cuda_stream),
           "riccati forward")
    launches["riccati_fwd"] += 1
    return x, u


def lqr_solve(A, B, b, Q, R, q, r, x0, reg: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LQR solve (S = 0), the contract of the JAX ``lqr_solve_pallas`` at
    any width B: A, B, R [N,12,12,B], b [N,12,B], q [N+1,12,B], r [N,12,B],
    x0 [12,B]. Returns (x [N+1,12,B], u [N,12,B])."""
    K, k = lqr_backward(A, B, b, Q, R, q, r, reg)
    x_rest, u = lqr_forward(A, B, b, K, k, x0)
    return torch.cat([x0[None], x_rest], dim=0), u
