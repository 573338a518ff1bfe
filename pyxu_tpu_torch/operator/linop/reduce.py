"""Reductions (counterpart of ``pyxu_tpu/operator/linop/reduce.py``):
``Sum`` over chosen axes; its adjoint broadcasts back (a view);
L = sqrt(the product of the reduced axes' sizes)."""

from __future__ import annotations

import math as _math

import numpy as np

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["Sum"]


class Sum(LinOp):
    def __init__(self, dim_shape, axis=None):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        if axis is None:
            axis = tuple(range(rank))
        axis = (axis,) if isinstance(axis, (int, np.integer)) else tuple(axis)
        axis = tuple(sorted({a % rank for a in axis}))
        super().__init__(dim_shape, tuple(n for i, n in enumerate(dim_shape)
                                          if i not in axis))
        self._axis = axis
        self._lipschitz = _math.sqrt(float(np.prod([dim_shape[a]
                                                    for a in axis])))
        self._name = "Sum"

    def apply(self, arr):
        nb = arr.ndim - self.dim_rank
        return arr.sum(dim=tuple(nb + a for a in self._axis))

    def adjoint(self, arr):
        nb = arr.ndim - self.codim_rank
        for a in self._axis:        # the reduced axes back, in order
            arr = arr.unsqueeze(nb + a)
        return arr.expand(tuple(arr.shape[:nb]) + self.dim_shape)

    def estimate_lipschitz(self, **kw):
        return self._lipschitz

    def _expr(self):
        return (f"Sum[axis={self._axis}]",)
