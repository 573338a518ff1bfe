"""Constant maps (counterpart of ``pyxu_tpu/operator/map/base.py``)."""

from __future__ import annotations

from pyxu_tpu_torch.abc.operator import DiffMap, ProxDiffFunc
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["ConstantValued"]


class _ConstantFunc(ProxDiffFunc):
    def __init__(self, dim_shape, cst: float):
        super().__init__(dim_shape)
        self._cst = float(cst)
        self._lipschitz = 0.0
        self._diff_lipschitz = 0.0

    def apply(self, arr):
        return arr.new_full(arr.shape[: arr.ndim - self.dim_rank], self._cst)

    def grad(self, arr):
        return arr.new_zeros(arr.shape)

    def prox(self, arr, tau):
        return arr


class _ConstantMap(DiffMap):
    def __init__(self, dim_shape, codim_shape, cst: float):
        super().__init__(dim_shape, codim_shape)
        self._cst = float(cst)
        self._lipschitz = 0.0
        self._diff_lipschitz = 0.0

    def apply(self, arr):
        batch = arr.shape[: arr.ndim - self.dim_rank]
        return arr.new_full(batch + self.codim_shape, self._cst)

    def jacobian(self, arr):
        from pyxu_tpu_torch.operator.linop.base import NullOp
        return NullOp(self.dim_shape, self.codim_shape)


def ConstantValued(dim_shape, codim_shape, cst: float):
    """x -> cst; a ProxDiffFunc when the codomain is scalar."""
    codim_shape = as_canonical_shape(codim_shape)
    if codim_shape in ((), (1,)):
        return _ConstantFunc(dim_shape, cst)
    return _ConstantMap(dim_shape, codim_shape, cst)
