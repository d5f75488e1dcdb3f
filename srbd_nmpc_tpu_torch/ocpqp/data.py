"""OCP-QP data: stage-stacked tensors in a plain dataclass (counterpart of
``srbd_nmpc_tpu/ocpqp/data.py``'s ``OcpQp``, its equality-constrained
part: the IPM's bound and general-constraint fields come with the IPM).

The QP over stages i = 0..N-1 (terminal N):

    min  sum_i 1/2 x_i' Q_i x_i + u_i' S_i x_i + 1/2 u_i' R_i u_i
              + q_i' x_i + r_i' u_i      (+ terminal 1/2 x_N' Q_N x_N + q_N' x_N)
    s.t. x_{i+1} = A_i x_i + B_i u_i + b_i
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OcpQp:
    """Stage-stacked OCP-QP data (leading batch axes allowed).

    Shapes (N = horizon):
      A [N,nx,nx]  B [N,nx,nu]  b [N,nx]
      Q [N+1,nx,nx]  q [N+1,nx]  S [N,nu,nx]  R [N,nu,nu]  r [N,nu]"""

    A: torch.Tensor
    B: torch.Tensor
    b: torch.Tensor
    Q: torch.Tensor
    S: torch.Tensor
    R: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
