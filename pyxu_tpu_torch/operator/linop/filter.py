"""Classic correlation filters and the structure tensor (counterpart of
``pyxu_tpu/operator/linop/filter.py``).

Thin kernel factories over :class:`Stencil`, with float64 host taps (a
Stencil applies them in its input's dtype); the separable ones reach the
hand-written stencil kernel on the card when the Stencil's rule takes them
(2-D, constant or symmetric mode).  MovingAverage, Gaussian,
DifferenceOfGaussians (DoG), Laplace; Sobel / Prewitt / Scharr along one
``axis``, or with ``axis=None`` the gradient magnitude
``sqrt(sum_i S_i(x)^2 / D)`` as a composed DiffMap; and StructureTensor,
the Gaussian-smoothed outer product of the gradient, whose Jacobian is
written out (the smoothed symmetrised product of the gradients at the
point and of the tangent), so that it never differentiates a kernel.
"""

from __future__ import annotations

import math as _math
import numbers

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import DiffMap, LinOp
from pyxu_tpu_torch.operator.linop.diff import Gradient, _gauss_deriv_kernel
from pyxu_tpu_torch.operator.linop.stencil import Stencil
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = [
    "MovingAverage",
    "Gaussian",
    "DifferenceOfGaussians",
    "DoG",
    "Laplace",
    "Sobel",
    "Prewitt",
    "Scharr",
    "StructureTensor",
]


def _per_axis(v, rank):
    if isinstance(v, (list, tuple)):
        if len(v) != rank:
            raise ValueError(f"{v}: want one value per axis ({rank})")
        return tuple(v)
    return (v,) * rank


def _stencil(dim_shape, ks, cs, mode, name):
    op = Stencil(dim_shape, ks, cs, mode=mode) if len(dim_shape) > 1 else \
        Stencil(dim_shape, ks[0], cs[0], mode=mode)
    op._name = name
    return op


def MovingAverage(dim_shape, size, center=None, mode="constant"):
    """Uniform filter by separable 1-D kernels."""
    dim_shape = as_canonical_shape(dim_shape)
    D = len(dim_shape)
    sizes = _per_axis(size, D)
    if center is None:
        if not all(s % 2 == 1 for s in sizes):
            raise ValueError("an even size needs an explicit center")
        center = tuple(s // 2 for s in sizes)
    center = _per_axis(center, D)
    kernels = [np.ones(s) for s in sizes]
    kernels[0] = kernels[0] / float(np.prod(sizes))
    return _stencil(dim_shape, kernels, list(center), mode, "MovingAverage")


def _gauss_axis_kernels(D, sigma, truncate, order, sampling):
    ks, cs = [], []
    for s, t, o, dx in zip(_per_axis(sigma, D), _per_axis(truncate, D),
                           _per_axis(order, D), _per_axis(sampling, D)):
        # sigma in physical units -> pixels; derivative taps scaled by
        # sampling^order
        off, k = _gauss_deriv_kernel(int(o), float(s) / float(dx), float(t))
        ks.append(np.asarray(k) / float(dx) ** int(o))
        cs.append(int(-off[0]))
    return ks, cs


def Gaussian(dim_shape, sigma=1.0, truncate=3.0, order=0, mode="constant",
             sampling=1.0):
    """(Derivative-of-)Gaussian filter."""
    dim_shape = as_canonical_shape(dim_shape)
    ks, cs = _gauss_axis_kernels(len(dim_shape), sigma, truncate, order,
                                 sampling)
    return _stencil(dim_shape, ks, cs, mode, "Gaussian")


def DifferenceOfGaussians(dim_shape, low_sigma=1.0, high_sigma=None,
                          low_truncate=3.0, high_truncate=3.0,
                          mode="constant", sampling=1.0):
    """Difference-of-Gaussians band-pass."""
    dim_shape = as_canonical_shape(dim_shape)
    if high_sigma is None:
        high_sigma = tuple(1.6 * s for s in _per_axis(low_sigma,
                                                     len(dim_shape)))
    lo = Gaussian(dim_shape, sigma=low_sigma, truncate=low_truncate,
                  mode=mode, sampling=sampling)
    hi = Gaussian(dim_shape, sigma=high_sigma, truncate=high_truncate,
                  mode=mode, sampling=sampling)
    op = lo - hi
    op._name = "DifferenceOfGaussians"
    return op


def Laplace(dim_shape, mode="constant", sampling=1.0):
    """Discrete Laplace filter: the sum over axes of [1, -2, 1] / sampling
    (one full, non-separable kernel)."""
    dim_shape = as_canonical_shape(dim_shape)
    D = len(dim_shape)
    samps = _per_axis(sampling, D)
    k = np.zeros((3,) * D)
    for ax in range(D):
        for v, val in ((0, 1.0), (1, -2.0), (2, 1.0)):
            j = [1] * D
            j[ax] = v
            k[tuple(j)] += val / float(samps[ax])
    op = Stencil(dim_shape, k, (1,) * D, mode=mode)
    op._name = "Laplace"
    return op


def _edge_filter(dim_shape, axis, smooth, mode, sampling, name):
    """The separable edge Stencil: the correlation derivative [-1, 0, 1]
    along ``axis``, the smoothing taps along the others."""
    D = len(dim_shape)
    samps = _per_axis(sampling, D)
    ks = [np.asarray([-1.0, 0.0, 1.0] if ax == axis else smooth)
          / float(samps[ax]) for ax in range(D)]
    return _stencil(dim_shape, ks, [1] * D, mode, name)


def _edge_family(name, smooth):
    def factory(dim_shape, axis=None, mode="constant", sampling=1.0):
        """``axis`` given (or 1-D): the separable edge Stencil along it;
        ``axis=None``: the gradient magnitude, the DiffMap
        ``(1/sqrt(D)) sqrt(sum_i square(S_i))``."""
        from pyxu_tpu_torch.operator.map.ufunc import sqrt, square
        dim_shape = as_canonical_shape(dim_shape)
        D = len(dim_shape)
        if axis is not None and (isinstance(axis, bool)
                                 or not isinstance(axis, numbers.Integral)):
            raise ValueError(
                f"{name}: axis must be an int or None, not {axis!r}")
        if axis is not None or D == 1:
            return _edge_filter(dim_shape, 0 if axis is None else int(axis),
                                smooth, mode, sampling, name)
        op = None
        for ax in range(D):
            t = square(_edge_filter(dim_shape, ax, smooth, mode, sampling,
                                    name))
            op = t if op is None else op + t
        op = (1.0 / _math.sqrt(D)) * sqrt(op)
        op._name = name
        return op
    factory.__name__ = name
    factory.__doc__ = f"{name} edge filter."
    return factory


# normalised smoothing taps: [1,2,1]/4, [1,1,1]/3, [3,10,3]/16
Sobel = _edge_family("Sobel", [0.25, 0.5, 0.25])
Prewitt = _edge_family("Prewitt", [1 / 3, 1 / 3, 1 / 3])
Scharr = _edge_family("Scharr", [3 / 16, 10 / 16, 3 / 16])



class StructureTensor(DiffMap):
    """The smoothed outer product of the gradient: ``g_i g_j`` for the
    D(D+1)/2 pairs i <= j, each smoothed by a Gaussian of
    ``smooth_sigma`` (none when it is 0); codim ``(D(D+1)/2,
    *dim_shape)``."""

    def __init__(self, dim_shape, diff_method="fd", smooth_sigma=1.0,
                 smooth_truncate=3.0, mode="constant", sampling=1.0,
                 **diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        D = len(dim_shape)
        self._pairs = [(i, j) for i in range(D) for j in range(i, D)]
        super().__init__(dim_shape, (len(self._pairs),) + tuple(dim_shape))
        self._grad = Gradient(dim_shape, diff_method=diff_method, mode=mode,
                              sampling=sampling, **diff_kwargs)
        self._smooth = (Gaussian(dim_shape, sigma=smooth_sigma,
                                 truncate=smooth_truncate, mode=mode)
                        if smooth_sigma else None)
        self._name = "StructureTensor"

    def _smoothed(self, t):
        return self._smooth.apply(t) if self._smooth is not None else t

    def apply(self, arr):
        g = self._grad.apply(arr)              # (*batch, D, *sp)
        ax = arr.ndim - self.dim_rank
        return torch.stack([self._smoothed(g.select(ax, i) * g.select(ax, j))
                            for i, j in self._pairs], dim=ax)

    def jacobian(self, arr):
        return _StructureTensorJac(self, torch.as_tensor(arr))

    def _expr(self):
        return ("StructureTensor", self._grad)


class _StructureTensorJac(LinOp):
    """The structure tensor's Jacobian at a point x: v -> smooth(g_i(x)
    g_j(v) + g_j(x) g_i(v)) for each pair."""

    def __init__(self, op: StructureTensor, at):
        super().__init__(op.dim_shape, op.codim_shape)
        self._op = op
        self._g = op._grad.apply(at)            # (D, *sp)
        self._name = "Jacobian[StructureTensor]"

    def apply(self, arr):
        op, g = self._op, self._g.to(arr.dtype)
        gv = op._grad.apply(arr)
        ax = arr.ndim - self.dim_rank
        return torch.stack([op._smoothed(g[i] * gv.select(ax, j)
                                         + g[j] * gv.select(ax, i))
                            for i, j in op._pairs], dim=ax)

    def adjoint(self, arr):
        op, g = self._op, self._g.to(arr.dtype)
        ax = arr.ndim - self.codim_rank
        parts = [None] * len(g)
        for p, (i, j) in enumerate(op._pairs):
            s = arr.select(ax, p)
            if op._smooth is not None:
                s = op._smooth.adjoint(s)
            for a, b in ((i, j), (j, i)):
                t = g[b] * s
                parts[a] = t if parts[a] is None else parts[a] + t
        return op._grad.adjoint(torch.stack(parts, dim=ax))


DoG = DifferenceOfGaussians
