"""Multi-dimensional padding operator (counterpart of ``pyxu_tpu/operator/linop/pad.py``).

Modes constant / wrap / reflect / symmetric / edge.  Every mode but
``constant`` is a gather along each padded axis with the source indices of
``numpy.pad(arange(n), ...)``; its adjoint is the matching scatter-add
(``index_add``), which is exactly the "trim and fold the ghost regions
back" map.  ``constant`` pads with zeros and its adjoint trims.

Lipschitz: ``A^T A`` is diagonal with the copy multiplicity of each input
element, so ``L = sqrt(max multiplicity)``, computed on the host per axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["Pad"]

_MODES = ("constant", "wrap", "reflect", "symmetric", "edge")


def _as_pad_width(pad_width, rank: int):
    """Canonicalise to ((lo, hi), ...) per axis."""
    if isinstance(pad_width, (int, np.integer)):
        return tuple((int(pad_width), int(pad_width)) for _ in range(rank))
    pad_width = tuple(pad_width)
    if rank == 1 and len(pad_width) == 2 and all(
            isinstance(p, (int, np.integer)) for p in pad_width):
        return ((int(pad_width[0]), int(pad_width[1])),)
    out = []
    for p in pad_width:
        if isinstance(p, (int, np.integer)):
            out.append((int(p), int(p)))
        else:
            lo, hi = p
            out.append((int(lo), int(hi)))
    if len(out) != rank:
        raise ValueError(f"pad_width does not match rank {rank}")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _src_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of every padded position along one axis."""
    return np.pad(np.arange(n), (lo, hi), mode=mode)


def pad_axis(x: torch.Tensor, ax: int, lo: int, hi: int, mode: str):
    """Pad axis ``ax`` of ``x`` by (lo, hi) with numpy's mode semantics."""
    if lo == 0 and hi == 0:
        return x
    n = x.shape[ax]
    if mode == "constant":
        shp = list(x.shape)
        parts = []
        if lo:
            shp[ax] = lo
            parts.append(x.new_zeros(shp))
        parts.append(x)
        if hi:
            shp[ax] = hi
            parts.append(x.new_zeros(shp))
        return torch.cat(parts, dim=ax)
    idx = torch.as_tensor(_src_index(n, lo, hi, mode), device=x.device)
    return torch.index_select(x, ax, idx)


def pad_axis_adjoint(y: torch.Tensor, ax: int, lo: int, hi: int, n: int,
                     mode: str):
    """Adjoint of :func:`pad_axis`: fold the ghost regions back and trim."""
    if lo == 0 and hi == 0:
        return y
    if mode == "constant":
        return y.narrow(ax, lo, n)
    idx = torch.as_tensor(_src_index(n, lo, hi, mode), device=y.device)
    shp = list(y.shape)
    shp[ax] = n
    return y.new_zeros(shp).index_add_(ax, idx, y)


class Pad(LinOp):
    def __init__(self, dim_shape, pad_width, mode: str = "constant"):
        dim_shape = as_canonical_shape(dim_shape)
        pw = _as_pad_width(pad_width, len(dim_shape))
        codim_shape = tuple(n + lo + hi for n, (lo, hi) in zip(dim_shape, pw))
        super().__init__(dim_shape, codim_shape)
        mode = mode.lower()
        if mode not in _MODES:
            raise ValueError(f"mode {mode} not in {_MODES}")
        for n, (lo, hi) in zip(dim_shape, pw):
            lim = n - 1 if mode == "reflect" else n
            if max(lo, hi) > lim:
                raise ValueError(
                    "pad width exceeds axis length (ghost overlap)")
        self._pw = pw
        self._mode = mode
        self._name = f"Pad[{mode}]"
        if mode == "constant":
            self._lipschitz = 1.0
        else:
            m = 1.0
            for n, (lo, hi) in zip(dim_shape, pw):
                if lo or hi:
                    src = _src_index(n, lo, hi, mode)
                    m *= float(np.bincount(src, minlength=n).max())
            self._lipschitz = float(np.sqrt(m))

    def apply(self, arr):
        nb = arr.ndim - self.dim_rank
        for ax, (lo, hi) in enumerate(self._pw):
            arr = pad_axis(arr, nb + ax, lo, hi, self._mode)
        return arr

    def adjoint(self, arr):
        nb = arr.ndim - self.codim_rank
        for ax in reversed(range(self.dim_rank)):
            lo, hi = self._pw[ax]
            arr = pad_axis_adjoint(arr, nb + ax, lo, hi, self.dim_shape[ax],
                                   self._mode)
        return arr
