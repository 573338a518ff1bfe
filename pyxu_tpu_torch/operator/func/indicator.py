"""Indicator functionals of convex sets, whose proxes are projections
(counterpart of ``pyxu_tpu/operator/func/indicator.py``).

Each indicator is 0 on its set and +inf outside; membership is held with
the tolerance ``sqrt(eps)`` of the input's dtype.  The projections run on
the input's device: the L1 ball by the exact sort algorithm, ``RangeSet``
and ``AffineSet`` by the fixed-budget CG of :mod:`pyxu_tpu_torch.math.cg`,
an intersection by a fixed number of alternating projections (POCS).
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.abc.operator import LinFunc, ProxFunc
from pyxu_tpu_torch.operator.func.norm import _project_l1_ball

__all__ = [
    "L1Ball",
    "L2Ball",
    "LInfinityBall",
    "PositiveOrthant",
    "HyperSlab",
    "RangeSet",
    "AffineSet",
    "ConvexSetIntersection",
]


class _IndicatorFunc(ProxFunc):
    """0 on the set, +inf outside, for each batch element."""

    @property
    def _axes(self):
        return tuple(range(-self.dim_rank, 0))

    def _member(self, arr) -> torch.Tensor:
        """A bool for each batch element."""
        raise NotImplementedError

    def apply(self, arr):
        ok = self._member(arr)
        return torch.where(ok, 0.0, torch.inf).to(arr.dtype)

    @staticmethod
    def _tol(arr) -> float:
        return torch.finfo(arr.dtype).eps ** 0.5


class L1Ball(_IndicatorFunc):
    """{x : ||x||_1 <= radius}."""

    def __init__(self, dim_shape, radius: float = 1.0):
        super().__init__(dim_shape)
        self._radius = float(radius)

    def _member(self, arr):
        return torch.sum(torch.abs(arr), dim=self._axes) \
            <= self._radius * (1 + self._tol(arr))

    def prox(self, arr, tau):
        return _project_l1_ball(arr, self._radius, self.dim_rank)


class L2Ball(_IndicatorFunc):
    """{x : ||x||_2 <= radius}."""

    def __init__(self, dim_shape, radius: float = 1.0):
        super().__init__(dim_shape)
        self._radius = float(radius)

    def _member(self, arr):
        return torch.sqrt(torch.sum(arr * arr, dim=self._axes)) \
            <= self._radius * (1 + self._tol(arr))

    def prox(self, arr, tau):
        n = torch.sqrt(torch.sum(arr * arr, dim=self._axes, keepdim=True))
        tiny = torch.finfo(arr.dtype).tiny
        return torch.clamp(self._radius / torch.clamp(n, min=tiny),
                           max=1.0) * arr


class LInfinityBall(_IndicatorFunc):
    """{x : ||x||_inf <= radius}."""

    def __init__(self, dim_shape, radius: float = 1.0):
        super().__init__(dim_shape)
        self._radius = float(radius)

    def _member(self, arr):
        return torch.amax(torch.abs(arr), dim=self._axes) \
            <= self._radius * (1 + self._tol(arr))

    def prox(self, arr, tau):
        return torch.clamp(arr, -self._radius, self._radius)


class PositiveOrthant(_IndicatorFunc):
    """{x : x >= 0}."""

    def _member(self, arr):
        return torch.all((arr >= -self._tol(arr)).flatten(-self.dim_rank),
                         dim=-1)

    def prox(self, arr, tau):
        return torch.clamp(arr, min=0.0)


class HyperSlab(_IndicatorFunc):
    """{x : lb <= <a, x> <= ub}."""

    def __init__(self, a, lb: float, ub: float):
        """``a``: a :class:`LinFunc` or a tensor (or array) of the slab's
        normal."""
        if isinstance(a, LinFunc):
            vec = a.grad(torch.zeros(a.dim_shape))
        else:
            vec = torch.as_tensor(a)
        super().__init__(tuple(vec.shape))
        if not lb < ub:
            raise ValueError(f"want lb < ub, got {lb} and {ub}")
        self._a = vec
        self._lb, self._ub = float(lb), float(ub)

    def _member(self, arr):
        ip = torch.sum(arr * self._a.to(arr), dim=self._axes)
        t = self._tol(arr)
        return (ip >= self._lb - t) & (ip <= self._ub + t)

    def prox(self, arr, tau):
        a = self._a.to(arr)
        ip = torch.sum(arr * a, dim=self._axes, keepdim=True)
        up = torch.clamp(self._lb - ip, min=0.0)       # below the slab
        down = torch.clamp(self._ub - ip, max=0.0)     # above it
        return arr + (up + down) * a / torch.sum(a * a)


class RangeSet(_IndicatorFunc):
    """{x : x in range(A)}.  The prox is the orthogonal projection
    ``A (A^T A)^+ A^T x``, the inner solve by CG on ``A.gram()``
    (``cg_kwargs``: ``rtol``, default 1e-8; ``maxiter``, default twice
    A's dim size)."""

    def __init__(self, A, damp: float = 0.0, **cg_kwargs):
        super().__init__(A.codim_shape)
        self._A = A
        self._damp = float(damp)
        self._cg = dict(cg_kwargs)

    def _member(self, arr):
        p = self._project(arr)
        err = torch.sqrt(torch.sum((arr - p) ** 2, dim=self._axes))
        ref = torch.sqrt(torch.sum(arr * arr, dim=self._axes))
        return err <= self._tol(arr) * torch.clamp(ref, min=1.0)

    def _project(self, arr):
        from pyxu_tpu_torch.math.cg import cg_solve
        gram = self._A.gram()
        z = cg_solve(lambda v: gram.apply(v) + self._damp * v,
                     self._A.adjoint(arr), rtol=self._cg.get("rtol", 1e-8),
                     maxiter=self._cg.get("maxiter", 2 * self._A.dim_size),
                     core_ndim=self._A.dim_rank)
        return self._A.apply(z)

    def prox(self, arr, tau):
        return self._project(arr)


class AffineSet(_IndicatorFunc):
    """{x : A x = b}.  The prox is ``x - A^T (A A^T)^+ (A x - b)``, the
    inner solve by CG on ``A.cogram()`` (``cg_kwargs`` as in
    :class:`RangeSet`, the budget twice A's codim size)."""

    def __init__(self, A, b, **cg_kwargs):
        super().__init__(A.dim_shape)
        self._A = A
        self._b = torch.as_tensor(b)
        self._cg = dict(cg_kwargs)

    def _member(self, arr):
        r = self._A.apply(arr) - self._b.to(arr)
        axes = tuple(range(-self._A.codim_rank, 0))
        err = torch.sqrt(torch.sum(r * r, dim=axes))
        ref = float(torch.linalg.vector_norm(self._b.double()))
        return err <= self._tol(arr) * max(ref, 1.0)

    def prox(self, arr, tau):
        from pyxu_tpu_torch.math.cg import cg_solve
        r = self._A.apply(arr) - self._b.to(arr)
        z = cg_solve(self._A.cogram().apply, r,
                     rtol=self._cg.get("rtol", 1e-8),
                     maxiter=self._cg.get("maxiter", 2 * self._A.codim_size),
                     core_ndim=self._A.codim_rank)
        return arr - self._A.adjoint(z)


class ConvexSetIntersection(_IndicatorFunc):
    """The intersection of convex sets.  The prox runs ``n_iter`` rounds of
    alternating projections (POCS), which reach a point of the
    intersection, not always the nearest one."""

    def __init__(self, *funcs, n_iter: int = 32):
        if not funcs:
            raise ValueError("want at least one set")
        super().__init__(funcs[0].dim_shape)
        self._funcs = tuple(funcs)
        self._n_iter = int(n_iter)

    def _member(self, arr):
        ok = self._funcs[0]._member(arr)
        for f in self._funcs[1:]:
            ok = ok & f._member(arr)
        return ok

    def prox(self, arr, tau):
        x = arr
        for _ in range(self._n_iter):
            for f in self._funcs:
                x = f.prox(x, 1.0)
        return x
