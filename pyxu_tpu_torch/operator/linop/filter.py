"""Classic correlation filters (counterpart of
``pyxu_tpu/operator/linop/filter.py``).

Thin kernel factories over :class:`Stencil`, with float64 host taps (a
Stencil applies them in its input's dtype); the separable ones reach the
hand-written stencil kernel on the card when the Stencil's rule takes them
(2-D, constant or symmetric mode).  Ported: MovingAverage, Gaussian,
DifferenceOfGaussians (DoG), Laplace, and Sobel / Prewitt / Scharr with
``axis`` given.  The ``axis=None`` gradient-magnitude form of the edge
filters and StructureTensor wait for ``map/ufunc.py`` and the derivative
stack.
"""

from __future__ import annotations

import numpy as np

from pyxu_tpu_torch.operator.linop.diff import _gauss_deriv_kernel
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


def _edge_family(name, smooth):
    def factory(dim_shape, axis=None, mode="constant", sampling=1.0):
        """Separable edge filter: the correlation derivative [-1, 0, 1]
        along ``axis``, the smoothing taps along the others."""
        dim_shape = as_canonical_shape(dim_shape)
        D = len(dim_shape)
        if axis is None and D > 1:
            raise NotImplementedError(
                f"{name}(axis=None), the gradient magnitude, needs "
                "map/ufunc.py, which is not ported yet: pass axis")
        axis = 0 if axis is None else int(axis)
        samps = _per_axis(sampling, D)
        ks = [np.asarray([-1.0, 0.0, 1.0] if ax == axis else smooth)
              / float(samps[ax]) for ax in range(D)]
        return _stencil(dim_shape, ks, [1] * D, mode, name)
    factory.__name__ = name
    factory.__doc__ = f"{name} edge filter along ``axis``."
    return factory


# normalised smoothing taps: [1,2,1]/4, [1,1,1]/3, [3,10,3]/16
Sobel = _edge_family("Sobel", [0.25, 0.5, 0.25])
Prewitt = _edge_family("Prewitt", [1 / 3, 1 / 3, 1 / 3])
Scharr = _edge_family("Scharr", [3 / 16, 10 / 16, 3 / 16])

DoG = DifferenceOfGaussians
