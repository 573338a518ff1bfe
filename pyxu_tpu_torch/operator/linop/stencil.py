"""Stencil / correlation operators (counterpart of ``pyxu_tpu/operator/linop/stencil.py``).

A Stencil is::

    apply   = valid-correlation( Pad_mode(x) )        # same-size output
    adjoint = Pad_mode^T( full-correlation(y, flip(kernel)) )

Separable kernels are chained 1-D correlations.  Each correlation is a
weighted sum of shifted slices: plain tensor code, outside any hand-written
kernel, as the JAX package keeps it outside Pallas.  Taps live on the host
as numpy arrays (the fused-TV matcher reads them there) and are applied as
Python scalars, so they take the input's dtype.

Lipschitz via Young's inequality: ``L <= L_pad * prod ||k_i||_1``.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import SquareOp
from pyxu_tpu_torch.operator.linop.pad import Pad
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["Stencil", "Correlate"]


def _host(k) -> np.ndarray:
    if isinstance(k, torch.Tensor):
        return k.detach().cpu().numpy()
    return np.asarray(k)


def _corr(x: torch.Tensor, kernel: np.ndarray, padding, dim_rank: int):
    """Correlation over the trailing ``dim_rank`` axes of ``x`` as
    ``sum_t k[t] * x[shifted slice]``; ``padding`` is per-axis (lo, hi)
    zero padding."""
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


class Stencil(SquareOp):
    """Correlation with boundary handling."""

    def __init__(self, dim_shape, kernel, center, mode: str = "constant"):
        dim_shape = as_canonical_shape(dim_shape)
        super().__init__(dim_shape)
        D = len(dim_shape)
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

    def apply(self, arr):
        x = self._pad.apply(arr)
        for k in self._kernels:
            x = _corr(x, k, ((0, 0),) * self.dim_rank, self.dim_rank)
        return x

    def adjoint(self, arr):
        y = arr
        for k in reversed(self._kernels):
            kf = np.flip(k, axis=tuple(range(k.ndim)))
            y = _corr(y, kf, tuple((s - 1, s - 1) for s in k.shape),
                      self.dim_rank)
        return self._pad.adjoint(y)


Correlate = Stencil
