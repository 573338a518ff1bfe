"""Norm functionals with closed-form proxes (counterpart of
``pyxu_tpu/operator/func/norm.py``).

Ported: L1Norm, SquaredL2Norm and L21Norm, and the L1-ball projection
that ``L1Ball`` takes.  L2Norm, SquaredL1Norm, LInfinityNorm and
PositiveL1Norm are not ported yet.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import ProxFunc, QuadraticFunc
from pyxu_tpu_torch.operator.linop.base import HomothetyOp, NullFunc
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["L1Norm", "SquaredL2Norm", "L21Norm"]


class _NormFunc(ProxFunc):
    """Reduction over the trailing ``dim_rank`` axes."""

    @property
    def _axes(self):
        return tuple(range(-self.dim_rank, 0))


class L1Norm(_NormFunc):
    """f(x) = ||x||_1; prox = soft threshold."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = _math.sqrt(self.dim_size)

    def apply(self, arr):
        return torch.sum(torch.abs(arr), dim=self._axes)

    def prox(self, arr, tau):
        return torch.sign(arr) * torch.clamp(torch.abs(arr) - tau, min=0.0)


class SquaredL2Norm(QuadraticFunc):
    """f(x) = ||x||_2^2 (the reference's convention, not 1/2||x||^2):
    Q = 2I, grad = 2x, prox_tau(x) = x / (1 + 2 tau)."""

    def __init__(self, dim_shape):
        dim_shape = as_canonical_shape(dim_shape)
        super().__init__(dim_shape, Q=HomothetyOp(dim_shape, 2.0),
                         c=NullFunc(dim_shape), t=0.0)
        self._diff_lipschitz = 2.0
        self._name = "SquaredL2Norm"

    def apply(self, arr):
        return torch.sum(arr * arr, dim=tuple(range(-self.dim_rank, 0)))

    def grad(self, arr):
        return 2.0 * arr

    def prox(self, arr, tau):
        return arr / (1.0 + 2.0 * tau)


class L21Norm(_NormFunc):
    r"""Group-sparse mixed norm f(x) = sum_j ||x[:, j]||_2 over ``l2_axis``;
    prox = per-group block soft threshold."""

    def __init__(self, dim_shape, l2_axis=(0,)):
        dim_shape = as_canonical_shape(dim_shape)
        super().__init__(dim_shape)
        l2_axis = (l2_axis,) if isinstance(l2_axis, int) else tuple(l2_axis)
        rank = len(dim_shape)
        for a in l2_axis:
            if not (-rank <= a < rank):
                raise ValueError(
                    f"l2_axis entry {a} out of range for rank-{rank} input")
        canon = tuple(a % rank for a in l2_axis)
        if len(set(canon)) != len(canon):
            raise ValueError(f"duplicate axes in l2_axis: {l2_axis}")
        self._l2_axis = canon

    def _core_axes(self, arr):
        off = arr.ndim - self.dim_rank
        l2 = tuple(off + a for a in self._l2_axis)
        l1 = tuple(off + a for a in range(self.dim_rank)
                   if a not in self._l2_axis)
        return l2, l1

    def apply(self, arr):
        l2, l1 = self._core_axes(arr)
        g = torch.sqrt(torch.sum(arr * arr, dim=l2))
        l1_shifted = tuple(a - sum(1 for b in l2 if b < a) for a in l1)
        return torch.sum(g, dim=l1_shifted) if l1_shifted else g

    def prox(self, arr, tau):
        l2, _ = self._core_axes(arr)
        n = torch.sqrt(torch.sum(arr * arr, dim=l2, keepdim=True))
        tiny = torch.finfo(arr.dtype).tiny
        return torch.clamp(1.0 - tau / torch.clamp(n, min=tiny), min=0.0) * arr


def _project_l1_ball(arr, radius: float, dim_rank: int):
    """Euclidean projection onto the L1 ball of ``radius``, by the exact
    sort-based algorithm (Duchi et al. 2008), batched over the axes ahead
    of the trailing ``dim_rank``."""
    batch = arr.shape[: arr.ndim - dim_rank]
    n = int(np.prod(arr.shape[arr.ndim - dim_rank:]))
    flat = arr.reshape(batch + (n,))
    a = torch.abs(flat)
    inside = torch.sum(a, dim=-1, keepdim=True) <= radius
    u = torch.sort(a, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, n + 1, dtype=arr.dtype, device=arr.device)
    k_star = torch.sum(u * k > css - radius, dim=-1, keepdim=True)
    idx = torch.clamp(k_star - 1, min=0)
    theta = (torch.gather(css, -1, idx) - radius) / torch.clamp(
        k_star.to(arr.dtype), min=1.0)
    proj = torch.sign(flat) * torch.clamp(a - theta, min=0.0)
    return torch.where(inside, flat, proj).reshape(arr.shape)
