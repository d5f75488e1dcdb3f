"""Small-matrix products in batch-last ("SoA") layout ``[n, m, B]``.

Counterpart of ``srbd_nmpc_tpu/ops/smallmat.py``. Every contraction is the
same explicit k-loop of rank-1 updates as the JAX version, never
``einsum``/``bmm``: each lane's arithmetic is then the same sequence of
elementwise operations whatever the batch width, which is what keeps a
compacted solve bitwise equal to the full-width one.

All functions take arrays with leading static matrix dims and any number
of trailing batch axes. The JAX helpers ``_at``/``row`` (slice-based
indexing that Mosaic accepts) are plain tensor indexing here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j,...] = sum_k a[i,k,...] b[k,j,...]."""
    acc = a[:, 0:1] * b[0:1]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j,...] = sum_k a[k,i,...] b[k,j,...]  (a' @ b)."""
    acc = a[0].unsqueeze(1) * b[0:1]
    for k in range(1, a.shape[0]):
        acc = acc + a[k].unsqueeze(1) * b[k:k + 1]
    return acc


def mmt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j,...] = sum_k a[i,k,...] b[j,k,...]  (a @ b')."""
    acc = a[:, 0:1] * b[:, 0].unsqueeze(0)
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[:, k].unsqueeze(0)
    return acc


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[i,...] = sum_k a[i,k,...] v[k,...]."""
    acc = a[:, 0] * v[0:1]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k] * v[k:k + 1]
    return acc


def mtv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[i,...] = sum_k a[k,i,...] v[k,...]  (a' @ v)."""
    acc = a[0] * v[0:1]
    for k in range(1, a.shape[0]):
        acc = acc + a[k] * v[k:k + 1]
    return acc


def sum_rows(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis as an explicit left-to-right loop (the
    order the CUDA kernels accumulate in)."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def transpose(a: torch.Tensor) -> torch.Tensor:
    """Swap the two leading (matrix) axes."""
    return a.transpose(0, 1)


def sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + transpose(a))


def gram(y: torch.Tensor) -> torch.Tensor:
    """y' y for y [k, n, ...], computing the top [h, n] strip and the
    bottom-right block (h = n // 2) and mirroring the rest. Bitwise equal
    to ``mtm(y, y)`` after a 0.5 (X + X') symmetrization: each computed
    entry uses mtm's k-order, and entries (i, j) and (j, i) of mtm(y, y)
    are the same products summed in the same order."""
    n = y.shape[1]
    h = n // 2
    top = mtm(y[:, :h], y)                         # [h, n, ...]
    br = mtm(y[:, h:], y[:, h:])                   # [n-h, n-h, ...]
    bottom = torch.cat([top[:, h:].transpose(0, 1), br], dim=1)
    return torch.cat([top, bottom], dim=0)


def add_diag(a: torch.Tensor, val) -> torch.Tensor:
    """a + val * I on the leading two axes."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).reshape(
        (n, n) + (1,) * (a.dim() - 2))
    return a + val * eye


def cholesky(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-looking Cholesky of an SPD [n, n, ...] matrix.

    Returns (L, dinv): L lower-triangular (zeros above), dinv[j] =
    1 / L[j, j] computed with ``rsqrt`` (division-free, as in JAX)."""
    n = G.shape[0]
    mask_shape = (n,) + (1,) * (G.dim() - 2)
    idx = torch.arange(n, device=G.device)
    S = G
    cols, dinvs = [], []
    for j in range(n):
        dinv = torch.rsqrt(S[j, j])
        mask = (idx >= j).to(G.dtype).reshape(mask_shape)
        col = S[:, j] * dinv.unsqueeze(0) * mask          # [n, ...]
        cols.append(col)
        dinvs.append(dinv)
        if j + 1 < n:
            S = S - col.unsqueeze(1) * col.unsqueeze(0)
    return torch.stack(cols, dim=1), torch.stack(dinvs, dim=0)


def fwd_subst(L: torch.Tensor, dinv: torch.Tensor, R: torch.Tensor
              ) -> torch.Tensor:
    """Solve L Y = R for R [n, m, ...] given ``cholesky``'s output."""
    n = L.shape[0]
    Y = R
    ys = []
    for i in range(n):
        yi = Y[i] * dinv[i:i + 1]
        ys.append(yi)
        if i + 1 < n:
            Y = Y - L[:, i:i + 1] * yi.unsqueeze(0)
    return torch.stack(ys, dim=0)


def bwd_subst(L: torch.Tensor, dinv: torch.Tensor, Y: torch.Tensor
              ) -> torch.Tensor:
    """Solve L' X = Y (upper-triangular backward substitution)."""
    n = L.shape[0]
    xs = [None] * n
    X = Y
    for i in reversed(range(n)):
        xi = X[i] * dinv[i:i + 1]
        xs[i] = xi
        if i > 0:
            X = X - L[i].unsqueeze(1) * xi.unsqueeze(0)
    return torch.stack(xs, dim=0)


def chol_solve(L: torch.Tensor, dinv: torch.Tensor, R: torch.Tensor
               ) -> torch.Tensor:
    """Solve (L L') X = R for R [n, m, ...] given ``cholesky``'s output."""
    return bwd_subst(L, dinv, fwd_subst(L, dinv, R))


def chol_solve_vec(L: torch.Tensor, dinv: torch.Tensor, r: torch.Tensor
                   ) -> torch.Tensor:
    """Solve (L L') x = r for a vector r [n, ...]."""
    return chol_solve(L, dinv, r.unsqueeze(1)).squeeze(1)
