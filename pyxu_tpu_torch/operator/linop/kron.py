r"""Matrix-free Kronecker products (counterpart of
``pyxu_tpu/operator/linop/kron.py``).

``kron(A, B) x = vec(A X B^T)`` with ``X = x.reshape(Na, Nb)`` (row-major):
B along the trailing axis, then A along the leading one.
``khatri_rao(A, B) x = vec(A diag(x) B^T)``, the column-wise Kronecker
product.  Both factors are 1-D -> 1-D operators.
"""

from __future__ import annotations

import math as _math

import torch

from pyxu_tpu_torch.abc.operator import LinOp

__all__ = ["kron", "khatri_rao"]


def _check_1d(*ops):
    for op in ops:
        if not op.dim_rank == op.codim_rank == 1:
            raise ValueError(f"{op.name}: a factor maps 1-D to 1-D")


class _Kron(LinOp):
    def __init__(self, A: LinOp, B: LinOp):
        _check_1d(A, B)
        super().__init__((A.dim_size * B.dim_size,),
                         (A.codim_size * B.codim_size,))
        self._A, self._B = A, B
        if _math.isfinite(A.lipschitz) and _math.isfinite(B.lipschitz):
            self._lipschitz = A.lipschitz * B.lipschitz
        self._name = "Kron"

    @staticmethod
    def _eval(arr, fA, fB, na, nb, ma, mb):
        batch = arr.shape[:-1]
        Y = fB(arr.reshape(batch + (na, nb)))       # (*batch, na, mb)
        Z = fA(Y.transpose(-1, -2))                 # (*batch, mb, ma)
        return Z.transpose(-1, -2).reshape(batch + (ma * mb,))

    def apply(self, arr):
        A, B = self._A, self._B
        return self._eval(arr, A.apply, B.apply, A.dim_size, B.dim_size,
                          A.codim_size, B.codim_size)

    def adjoint(self, arr):
        A, B = self._A, self._B
        return self._eval(arr, A.adjoint, B.adjoint, A.codim_size,
                          B.codim_size, A.dim_size, B.dim_size)

    def trace(self, **kw):
        """tr(A (x) B) = tr(A) tr(B)."""
        return float(self._A.trace(**kw)) * float(self._B.trace(**kw))

    def svdvals(self, k: int = 1, **kw):
        """The top-k products of the factors' singular values, ascending."""
        sa = self._A.svdvals(k=min(k, self._A.dim_size), **kw)
        sb = self._B.svdvals(k=min(k, self._B.dim_size), **kw)
        prod = (sa[:, None] * sb.to(sa)[None, :]).reshape(-1)
        return torch.sort(prod).values[-k:]

    def estimate_lipschitz(self, **kw):
        L = self._A.estimate_lipschitz(**kw) * self._B.estimate_lipschitz(
            **kw)
        self._lipschitz = L
        return L

    def _expr(self):
        return ("kron", self._A, self._B)


def kron(A: LinOp, B: LinOp) -> LinOp:
    return _Kron(A, B)


class _KhatriRao(LinOp):
    r"""(A (*) B) x = vec(A diag(x) B^T)."""

    def __init__(self, A: LinOp, B: LinOp):
        _check_1d(A, B)
        if A.dim_size != B.dim_size:
            raise ValueError("khatri_rao: the factors' column counts differ")
        super().__init__((A.dim_size,), (A.codim_size * B.codim_size,))
        self._A, self._B = A, B
        self._name = "KhatriRao"

    def apply(self, arr):
        A, B = self._A, self._B
        batch = arr.shape[:-1]
        n = A.dim_size
        X = arr[..., :, None] * torch.eye(n, dtype=arr.dtype,
                                          device=arr.device)  # (*b, n, n)
        W = B.apply(X).transpose(-1, -2)    # (*b, Mb, n): column j is x_j b_j
        Y = A.apply(W).transpose(-1, -2)    # (*b, Ma, Mb)
        return Y.reshape(batch + (A.codim_size * B.codim_size,))

    def adjoint(self, arr):
        A, B = self._A, self._B
        batch = arr.shape[:-1]
        Y = arr.reshape(batch + (A.codim_size, B.codim_size))
        T = A.adjoint(Y.transpose(-1, -2)).transpose(-1, -2)   # (*b, n, Mb)
        G = B.adjoint(T)                    # (*b, n, n): G[j] = B^T T[j]
        return torch.diagonal(G, dim1=-2, dim2=-1)

    def _expr(self):
        return ("khatri_rao", self._A, self._B)


def khatri_rao(A: LinOp, B: LinOp) -> LinOp:
    return _KhatriRao(A, B)
