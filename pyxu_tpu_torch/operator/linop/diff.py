"""Derivative operators (counterpart of ``pyxu_tpu/operator/linop/diff.py``).

Finite-difference taps are solved on the host in float64 (Vandermonde
system) and applied through the separable :class:`Stencil`.  Ported:
``PartialDerivative.finite_difference``, ``_StackedDiff`` and ``Gradient``;
Gaussian derivatives and the rest of the derivative stack are not ported
yet.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.operator.linop.stencil import Stencil
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["PartialDerivative", "Gradient"]


def _fd_coeffs(deriv: int, scheme: str = "forward", accuracy: int = 1):
    """Offsets and coefficients of the finite difference for
    d^deriv/dx^deriv: solves sum_j c_j o_j^k = k! delta_{k,deriv}."""
    if deriv == 0:
        return np.array([0]), np.array([1.0])
    if scheme == "central":
        acc = accuracy + (accuracy % 2)
        half = (deriv + 1) // 2 - 1 + acc // 2
        offsets = np.arange(-half, half + 1)
    elif scheme == "forward":
        offsets = np.arange(0, deriv + accuracy)
    elif scheme == "backward":
        offsets = np.arange(-(deriv + accuracy) + 1, 1)
    else:
        raise ValueError(
            f"scheme {scheme!r} not in ('central','forward','backward')")
    n = len(offsets)
    V = np.vander(offsets.astype(np.float64), n, increasing=True).T
    rhs = np.zeros(n)
    rhs[deriv] = _math.factorial(deriv)
    coeffs = np.linalg.solve(V, rhs)
    coeffs[np.abs(coeffs) < 1e-12] = 0.0
    return offsets, coeffs


def _gauss_deriv_kernel(deriv: int, sigma: float, truncate: float = 3.0):
    """Offsets and taps of the order-``deriv`` Gaussian derivative, by the
    Hermite recurrence p_{n+1} = p_n' - (x / sigma^2) p_n on
    g(x) = exp(-x^2 / 2 sigma^2).  The taps are flipped: a Stencil
    correlates, and the derivative is a convolution kernel."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    p = np.polynomial.Polynomial([1.0])
    dgauss = np.polynomial.Polynomial([0.0, -1.0 / sigma ** 2])
    for _ in range(deriv):
        p = p.deriv() + p * dgauss
    return x.astype(np.int64), (p(x) * g)[::-1]


def _per_axis(v, rank: int) -> tuple:
    if isinstance(v, (list, tuple)):
        if len(v) != rank:
            raise ValueError(f"{v}: want one value per axis ({rank})")
        return tuple(v)
    return (v,) * rank


class PartialDerivative:
    """Factory namespace.  ``order`` is a per-axis tuple of derivative
    orders; the result is a separable :class:`Stencil` scaled by the grid
    sampling."""

    @staticmethod
    def finite_difference(dim_shape, order, scheme="forward", accuracy=1,
                          mode="constant", sampling=1.0):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        order = (int(order),) if np.isscalar(order) else tuple(map(int, order))
        if len(order) != rank or any(o < 0 for o in order):
            raise ValueError(f"order {order} for a rank-{rank} operator")
        schemes = _per_axis(scheme, rank)
        accs = _per_axis(accuracy, rank)
        sampling = _per_axis(sampling, rank)
        kernels, centers, scale = [], [], 1.0
        for ax, o in enumerate(order):
            offsets, coeffs = _fd_coeffs(o, schemes[ax], accs[ax])
            kernels.append(coeffs)
            centers.append(int(-offsets[0]))
            scale /= float(sampling[ax]) ** o
        kernels[0] = kernels[0] * scale
        if rank == 1:
            op = Stencil(dim_shape, kernels[0], centers[0], mode=mode)
        else:
            op = Stencil(dim_shape, kernels, centers, mode=mode)
        op._name = f"PartialDerivative[{order}]"
        return op


class _StackedDiff(LinOp):
    """codim = (n_ops, *dim_shape): apply stacks the child outputs, adjoint
    sums the child adjoints."""

    def __init__(self, ops, name: str):
        dim_shape = ops[0].dim_shape
        super().__init__(dim_shape, (len(ops),) + tuple(dim_shape))
        self._ops = tuple(ops)
        self._lipschitz = _math.sqrt(sum(o.lipschitz ** 2 for o in ops))
        self._name = name

    def apply(self, arr):
        return torch.stack([op.apply(arr) for op in self._ops],
                           dim=arr.ndim - self.dim_rank)

    def adjoint(self, arr):
        ax = arr.ndim - self.codim_rank
        out = None
        for i, op in enumerate(self._ops):
            t = op.adjoint(arr.select(ax, i))
            out = t if out is None else out + t
        return out


def Gradient(dim_shape, directions=None, mode="constant", sampling=1.0,
             scheme="forward", accuracy=1):
    """Stack of first-order finite-difference partials; codim
    ``(D, *dim_shape)``."""
    dim_shape = as_canonical_shape(dim_shape)
    rank = len(dim_shape)
    directions = tuple(range(rank)) if directions is None else tuple(directions)
    ops = []
    for ax in directions:
        order = [0] * rank
        order[ax] = 1
        ops.append(PartialDerivative.finite_difference(
            dim_shape, tuple(order), scheme=scheme, accuracy=accuracy,
            mode=mode, sampling=sampling))
    return _StackedDiff(ops, "Gradient")
