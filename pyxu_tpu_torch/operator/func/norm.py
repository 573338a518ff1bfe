"""Norm functionals with closed-form proxes (counterpart of
``pyxu_tpu/operator/func/norm.py``).

L1Norm, L2Norm, SquaredL2Norm, SquaredL1Norm (the exact sort-based prox,
or ``prox_algo="root"``: 96 steps of geometric bisection), LInfinityNorm
(through the exact L1-ball projection), L21Norm and PositiveL1Norm, and
the L1-ball projection that ``L1Ball`` takes.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import ProxFunc, QuadraticFunc
from pyxu_tpu_torch.operator.linop.base import HomothetyOp, NullFunc
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["L1Norm", "L2Norm", "SquaredL2Norm", "SquaredL1Norm",
           "LInfinityNorm", "L21Norm", "PositiveL1Norm"]


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


class L2Norm(_NormFunc):
    """f(x) = ||x||_2; prox = block soft threshold."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 1.0
        self._diff_lipschitz = _math.inf

    def apply(self, arr):
        return torch.sqrt(torch.sum(arr * arr, dim=self._axes))

    def prox(self, arr, tau):
        n = torch.sqrt(torch.sum(arr * arr, dim=self._axes, keepdim=True))
        tiny = torch.finfo(arr.dtype).tiny
        return torch.clamp(1.0 - tau / torch.clamp(n, min=tiny), min=0.0) * arr


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


def _tau_col(tau, like):
    """``tau`` as a tensor of ``like``'s dtype, a trailing axis added when it
    is batched."""
    t = torch.as_tensor(tau, dtype=like.dtype, device=like.device)
    return t[..., None] if t.ndim else t


class SquaredL1Norm(_NormFunc):
    r"""f(x) = ||x||_1^2.

    ``prox_algo="sort"``: the exact formula.  With y = sort(|x|, desc) and
    S_k = sum_{i<=k} y_i, the largest k with y_k > 2 tau S_k / (1 + 2 tau
    k) sets the soft threshold mu = 2 tau S_k / (1 + 2 tau k).
    ``"root"``: Lemma 6.70 of Beck's First-Order Methods, the root of
    sum(clip(|x| sqrt(tau/mu) - 2 tau, 0)) = 1 found by 96 steps of
    geometric bisection on a scale-relative bracket.
    """

    def __init__(self, dim_shape, prox_algo: str = "sort"):
        super().__init__(dim_shape)
        algo = prox_algo.strip().lower()
        assert algo in ("sort", "root"), prox_algo
        self._algo = algo

    def apply(self, arr):
        return torch.sum(torch.abs(arr), dim=self._axes) ** 2

    def prox(self, arr, tau):
        if self._algo == "root":
            return self._prox_root(arr, tau)
        batch = arr.shape[: arr.ndim - self.dim_rank]
        flat = arr.reshape(batch + (self.dim_size,))
        y = torch.sort(torch.abs(flat), dim=-1, descending=True).values
        S = torch.cumsum(y, dim=-1)
        k = torch.arange(1, self.dim_size + 1, dtype=arr.dtype,
                         device=arr.device)
        t = _tau_col(tau, arr)
        thresh = 2.0 * t * S / (1.0 + 2.0 * t * k)
        k_star = torch.sum(y > thresh, dim=-1)
        idx = torch.clamp(k_star - 1, min=0)
        mu = torch.gather(thresh, -1, idx[..., None])[..., 0]
        mu = torch.where(k_star > 0, mu, 0.0)
        mu = mu.reshape(mu.shape + (1,) * self.dim_rank)
        return torch.sign(arr) * torch.clamp(torch.abs(arr) - mu, min=0.0)

    def _prox_root(self, arr, tau):
        """In the variable nu = mu / hi, hi = amax^2 / (4 tau), every
        quantity stays O(1) whatever the input's magnitude; f(nu = 1) = -1,
        so the root lies in (0, 1]."""
        batch = arr.shape[: arr.ndim - self.dim_rank]
        flat = arr.reshape(batch + (self.dim_size,))
        a = torch.abs(flat)
        t = torch.as_tensor(tau, dtype=arr.dtype, device=arr.device)
        if t.ndim:
            t = t.broadcast_to(batch)[..., None]
        amax = torch.clamp(torch.max(a, dim=-1, keepdim=True).values,
                           min=torch.finfo(arr.dtype).tiny)
        ah = a / amax

        def f(nu):
            lam = 2.0 * t * torch.clamp(ah / torch.sqrt(nu) - 1.0, min=0.0)
            return torch.sum(lam, dim=-1, keepdim=True) - 1.0

        lo = torch.full_like(amax, 1e-30)
        hi = torch.ones_like(amax)
        for _ in range(96):
            mid = torch.sqrt(lo * hi)
            go_up = f(mid) > 0               # the root lies above mid
            lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
        nu = torch.sqrt(lo * hi)
        lam = 2.0 * t * torch.clamp(ah / torch.sqrt(nu) - 1.0, min=0.0)
        out = flat * lam / (lam + 2.0 * t)
        nonzero = torch.sum(a, dim=-1, keepdim=True) > 0
        return torch.where(nonzero, out, flat).reshape(arr.shape)


class LInfinityNorm(_NormFunc):
    r"""f(x) = ||x||_inf; prox_tau(x) = x - tau proj_{L1 ball}(x / tau), by
    the exact sort-based projection."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 1.0

    def apply(self, arr):
        return torch.amax(torch.abs(arr), dim=self._axes)

    def prox(self, arr, tau):
        t = torch.as_tensor(tau, dtype=arr.dtype, device=arr.device)
        # the tau -> 0 limit is the identity; a bare division gives NaN
        safe = torch.clamp(t, min=torch.finfo(arr.dtype).tiny)
        proj = _project_l1_ball(arr / safe, 1.0, self.dim_rank)
        return torch.where(t > 0, arr - t * proj, arr)


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


class PositiveL1Norm(_NormFunc):
    r"""f(x) = ||x||_1 + i_{x >= 0}(x)."""

    def apply(self, arr):
        penalty = torch.any(arr < 0, dim=self._axes)
        l1 = torch.sum(torch.abs(arr), dim=self._axes)
        return torch.where(penalty, torch.inf, l1)

    def prox(self, arr, tau):
        return torch.clamp(arr - tau, min=0.0)


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
