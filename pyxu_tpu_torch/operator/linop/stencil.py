"""Stencil / correlation / convolution operators (counterpart of
``pyxu_tpu/operator/linop/stencil.py``).

A Stencil is::

    apply   = valid-correlation( Pad_mode(x) )        # same-size output
    adjoint = Pad_mode^T( full-correlation(y, flip(kernel)) )

A 2-D separable Stencil (one 1-D kernel per axis) in ``constant`` or
``symmetric`` mode with at most 32 taps per axis runs through
:func:`pyxu_tpu_torch.ops.stencil.separable_correlate2d`: the hand-written
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.  The rule
is applied once, at construction, and recorded in ``kernel_path``
(``"kernel"`` or ``None``).  Every other separable Stencil (another rank,
the wrap/reflect/edge modes) runs that plain version's per-axis
correlation, :func:`~pyxu_tpu_torch.ops.stencil.fwd_axis` /
:func:`~pyxu_tpu_torch.ops.stencil.adj_axis`, axis by axis; a full kernel
is one N-D correlation written as a weighted sum of shifted slices of the
padded input.  Taps live on the host as numpy arrays (the fused-TV matcher
reads them there) and are applied as Python scalars, so they take the
input's dtype.  A bfloat16 or float16 input keeps its dtype and is
computed in float32 and rounded once: on the kernel path from taps rounded
to its dtype, as the kernel does, off it from the float32 taps.  The
kernel path differentiates through the wrapper's autograd rule (its
backward is the adjoint kernel), so ``grad``, ``jacobian`` and
``torch.func`` reach it.

Lipschitz via Young's inequality: ``L <= L_pad * prod ||k_i||_1``.
Closed-form trace in constant mode: ``tr = N * prod k_i[center_i]``.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import SquareOp
from pyxu_tpu_torch.operator.linop.pad import Pad
from pyxu_tpu_torch.ops import stencil as _kern
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["Stencil", "Correlate", "Convolve"]


def _host(k) -> np.ndarray:
    if isinstance(k, torch.Tensor):
        return k.detach().cpu().numpy()
    return np.asarray(k)


def _corr(x: torch.Tensor, kernel: np.ndarray, padding):
    """Correlation over the trailing ``kernel.ndim`` axes of ``x`` as
    ``sum_t k[t] * x[shifted slice]``; ``padding`` is per-axis (lo, hi)
    zero padding."""
    dim_rank = kernel.ndim
    nb = x.ndim - dim_rank
    if any(p != (0, 0) for p in padding):
        flat = []
        for lo, hi in reversed(padding):    # F.pad lists the last axis first
            flat += [lo, hi]
        x = torch.nn.functional.pad(x, flat)
    out_sp = tuple(x.shape[nb + d] - kernel.shape[d] + 1
                   for d in range(dim_rank))
    out = None
    for tap in np.ndindex(*kernel.shape):
        idx = (Ellipsis,) + tuple(slice(tap[d], tap[d] + out_sp[d])
                                  for d in range(dim_rank))
        term = float(kernel[tap]) * x[idx]
        out = term if out is None else out + term
    return out


def _canonical_kernels(kernel, center, dim_rank: int):
    """Normalise to a list of (full-rank host kernel array, center tuple)."""
    if isinstance(kernel, (list, tuple)) and not np.isscalar(kernel[0]):
        first = _host(kernel[0])
        if first.ndim == 1 and len(kernel) == dim_rank and dim_rank > 1:
            out = []          # separable: one 1-D kernel per axis
            for ax, (k1, c1) in enumerate(zip(kernel, center)):
                k1 = _host(k1)
                if k1.ndim != 1:
                    raise ValueError("separable kernels are 1-D")
                shape = [1] * dim_rank
                shape[ax] = k1.shape[0]
                ctr = [0] * dim_rank
                ctr[ax] = int(np.asarray(c1).ravel()[0])
                out.append((k1.reshape(shape), tuple(ctr)))
            return out
    k = _host(kernel)
    if k.ndim != dim_rank:
        raise ValueError(f"kernel rank {k.ndim} != dim rank {dim_rank}")
    center = tuple(int(c) for c in as_canonical_shape(center))
    if len(center) != dim_rank:
        raise ValueError(f"center {center} does not match rank {dim_rank}")
    return [(k, center)]


def _sep_taps(kernels, centers, mode: str):
    """The kernel's :class:`SepTaps` when the Stencil is 2-D separable with
    real floating taps and the kernel takes it, else None."""
    if len(kernels) != 2 or any(k.ndim != 2 for k in kernels):
        return None
    k0, k1 = kernels
    if k0.shape[1] != 1 or k1.shape[0] != 1:
        return None
    if not all(np.issubdtype(k.dtype, np.floating) for k in kernels):
        return None
    p = _kern.SepTaps(k0=tuple(float(v) for v in k0.ravel()),
                      c0=int(centers[0][0]),
                      k1=tuple(float(v) for v in k1.ravel()),
                      c1=int(centers[1][1]), mode=mode)
    return p if _kern.kernel_takes(p) else None


class Stencil(SquareOp):
    """Correlation with boundary handling."""

    # derived from the taps (``operator/blocks.py`` homogeneity compares
    # the taps themselves, as the JAX package's array leaves)
    _batch_derived = ("_taps", "_axes")

    def __init__(self, dim_shape, kernel, center, mode: str = "constant"):
        dim_shape = as_canonical_shape(dim_shape)
        super().__init__(dim_shape)
        D = len(dim_shape)
        mode = mode.lower()
        kc = _canonical_kernels(kernel, center, D)
        self._kernels = tuple(k for k, _ in kc)
        self._centers = tuple(c for _, c in kc)
        lo = [0] * D
        hi = [0] * D
        for k, c in kc:
            for ax in range(D):
                lo[ax] += c[ax]
                hi[ax] += k.shape[ax] - 1 - c[ax]
        self._pad = Pad(dim_shape, tuple(zip(lo, hi)), mode=mode)
        self._mode = mode
        l1 = 1.0
        for k in self._kernels:
            l1 *= float(np.sum(np.abs(k), dtype=k.dtype))
        self._lipschitz = self._pad.lipschitz * l1
        self._name = f"Stencil[{mode}]"
        self._taps = _sep_taps(self._kernels, self._centers, mode)
        self.kernel_path = "kernel" if self._taps is not None else None
        # separable: (1-D taps, centre, axis) per axis, for the plain path
        self._axes = None if len(kc) == 1 else tuple(
            (k.ravel(), c[ax], ax) for ax, (k, c) in enumerate(kc))

    @property
    def kernel(self):
        return self._kernels if len(self._kernels) > 1 else self._kernels[0]

    @property
    def center(self):
        return self._centers if len(self._centers) > 1 else self._centers[0]

    def _axis_centers(self) -> tuple:
        """Per-axis scalar center, collapsing the separable representation."""
        if len(self._centers) == 1:
            return self._centers[0]
        return tuple(self._centers[ax][ax] for ax in range(self.dim_rank))

    @property
    def relative_indices(self) -> list:
        """Relative kernel indices per dimension."""
        ctr = self._axis_centers()
        if len(self._kernels) == 1:
            sizes = self._kernels[0].shape
        else:
            sizes = tuple(self._kernels[ax].shape[ax]
                          for ax in range(self.dim_rank))
        return [np.arange(s) - c for c, s in zip(ctr, sizes)]

    def visualize(self) -> str:
        """Stringified D-dimensional kernel with the center in parentheses."""
        kernel = np.asarray(self._kernels[0])
        for k in self._kernels[1:]:
            kernel = kernel * np.asarray(k)
        kernel = kernel.astype(str)
        ctr = self._axis_centers()
        kernel[ctr] = "(" + kernel[ctr] + ")"
        return np.array2string(kernel).replace("'", "")

    def configure_dispatcher(self, **kwargs):
        """No-op (the reference tunes a CuPy dispatcher here); returns self
        for call-chaining."""
        return self

    def apply(self, arr):
        if self.kernel_path == "kernel":
            return _kern.separable_correlate2d(arr.contiguous(), self._taps)
        if arr.dtype in _kern.NARROW:
            return self.apply(arr.float()).to(arr.dtype)
        if self._axes is not None:
            nb = arr.ndim - self.dim_rank
            for k, c, ax in self._axes:
                arr = _kern.fwd_axis(arr, k, c, nb + ax, self._mode)
            return arr
        return _corr(self._pad.apply(arr), self._kernels[0],
                     ((0, 0),) * self.dim_rank)

    def adjoint(self, arr):
        if self.kernel_path == "kernel":
            return _kern.separable_correlate2d(arr.contiguous(), self._taps,
                                               adjoint=True)
        if arr.dtype in _kern.NARROW:
            return self.adjoint(arr.float()).to(arr.dtype)
        if self._axes is not None:
            nb = arr.ndim - self.dim_rank
            for k, c, ax in reversed(self._axes):
                arr = _kern.adj_axis(arr, k, c, nb + ax, self._mode)
            return arr
        k = self._kernels[0]
        y = _corr(arr, np.flip(k), tuple((s - 1, s - 1) for s in k.shape))
        return self._pad.adjoint(y)

    def trace(self, method: str = "explicit", **kwargs):
        if self._mode == "constant":
            tap = 1.0
            for k, c in zip(self._kernels, self._centers):
                tap *= float(k[tuple(c)])
            return tap * self.dim_size
        return super().trace(method=method, **kwargs)

    def _expr(self):
        ks = "x".join(str(tuple(k.shape)) for k in self._kernels)
        return (f"Stencil[{self._mode}, kernels={ks}]",)


Correlate = Stencil


class Convolve(Stencil):
    """True convolution: correlation with the flipped kernel and the
    mirrored center."""

    def __init__(self, dim_shape, kernel, center, mode: str = "constant"):
        D = len(as_canonical_shape(dim_shape))
        kc = _canonical_kernels(kernel, center, D)
        flipped, centers = [], []
        for k, c in kc:
            flipped.append(np.flip(k, axis=tuple(range(k.ndim))))
            centers.append(tuple(s - 1 - ci for s, ci in zip(k.shape, c)))
        if len(flipped) == 1:
            super().__init__(dim_shape, flipped[0], centers[0], mode=mode)
        else:
            super().__init__(dim_shape, [kf.ravel() for kf in flipped],
                             [cf[ax] for ax, cf in enumerate(centers)],
                             mode=mode)
        self._name = f"Convolve[{mode}]"
