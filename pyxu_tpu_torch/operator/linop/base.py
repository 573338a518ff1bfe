"""Elementary linear operators (counterpart of ``pyxu_tpu/operator/linop/base.py``).

Ported: IdentityOp, NullOp, NullFunc, HomothetyOp and ExplicitLinFunc — the
operators the rule engine creates on the TV path.  DiagonalOp,
ExplicitLinOp and SparseExplicitLinOp are not ported yet.
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.abc.operator import (
    LinFunc,
    LinOp,
    PosDefOp,
    SelfAdjointOp,
)

__all__ = [
    "IdentityOp",
    "NullOp",
    "NullFunc",
    "HomothetyOp",
    "ExplicitLinFunc",
]


class IdentityOp(PosDefOp):
    """x -> x."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 1.0

    def apply(self, arr):
        return arr

    def adjoint(self, arr):
        return arr

    def gram(self):
        return self


class NullOp(LinOp):
    """x -> 0."""

    def __init__(self, dim_shape, codim_shape):
        super().__init__(dim_shape, codim_shape)
        self._lipschitz = 0.0

    def apply(self, arr):
        batch = arr.shape[: arr.ndim - self.dim_rank]
        return arr.new_zeros(batch + self.codim_shape)

    def adjoint(self, arr):
        batch = arr.shape[: arr.ndim - self.codim_rank]
        return arr.new_zeros(batch + self.dim_shape)


class NullFunc(LinFunc):
    """x -> 0 functional."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 0.0

    def apply(self, arr):
        return arr.new_zeros(arr.shape[: arr.ndim - self.dim_rank])

    def adjoint(self, arr):
        return arr.new_zeros(arr.shape + self.dim_shape)

    def grad(self, arr):
        return torch.zeros_like(arr)

    def prox(self, arr, tau):
        return arr


class HomothetyOp(SelfAdjointOp):
    """x -> cst * x; a ``PosDefOp`` when cst > 0."""

    def __new__(cls, dim_shape, cst: float):
        if cls is HomothetyOp and float(cst) > 0:
            return object.__new__(_PosDefHomothetyOp)
        return object.__new__(cls)

    def __init__(self, dim_shape, cst: float):
        super().__init__(dim_shape)
        self._cst = float(cst)
        self._lipschitz = abs(self._cst)

    def apply(self, arr):
        return self._cst * arr


class _PosDefHomothetyOp(HomothetyOp, PosDefOp):
    pass


class ExplicitLinFunc(LinFunc):
    """f(x) = <w, x> from an explicit vector (kept on its own device)."""

    def __init__(self, vec: torch.Tensor):
        super().__init__(tuple(vec.shape))
        self._vec = vec
        self._name = "ExplicitLinFunc"

    def _w(self, like):
        return self._vec.to(dtype=like.dtype)

    def apply(self, arr):
        return torch.sum(arr * self._w(arr),
                         dim=tuple(range(-self.dim_rank, 0)))

    def adjoint(self, arr):
        return arr.reshape(arr.shape + (1,) * self.dim_rank) * self._w(arr)
