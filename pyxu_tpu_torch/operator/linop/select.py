"""Sub-sampling and trimming (counterpart of
``pyxu_tpu/operator/linop/select.py``).

``SubSample`` keeps a sub-tensor given per-axis specs (an int, a slice, a
boolean mask or a list of indices); its adjoint scatters back into zeros,
adding repeated indices.  The indices are host numpy arrays
(``_StaticIndex``); an axis whose indices are an increasing arithmetic
progression is taken as a slice (a view), any other as an
``index_select`` whose index tensor is copied to a device once and kept.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.operator.linop.pad import _as_pad_width
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["SubSample", "Trim"]


class _StaticIndex:
    """A host index array (int64)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = np.ascontiguousarray(np.asarray(arr, np.int64))

    def __len__(self):
        return len(self.arr)

    def as_slice(self):
        """The indices as a slice when they step up evenly, else None."""
        a = self.arr
        if len(a) == 0:
            return None
        step = int(a[1] - a[0]) if len(a) > 1 else 1
        if step <= 0 or not np.array_equal(
                a, a[0] + step * np.arange(len(a))):
            return None
        return slice(int(a[0]), int(a[-1]) + 1, step)


class SubSample(LinOp):
    """Keep ``x[indices]`` per axis (trailing axes unspecified are kept
    whole); L = prod over axes of sqrt(the largest index multiplicity)."""

    def __init__(self, dim_shape, *indices):
        dim_shape = as_canonical_shape(dim_shape)
        if len(indices) > len(dim_shape):
            raise ValueError("more index specs than axes")
        specs = []
        for ax, n in enumerate(dim_shape):
            spec = indices[ax] if ax < len(indices) else slice(None)
            if isinstance(spec, (int, np.integer)):
                idx = np.asarray([int(spec)])
            elif isinstance(spec, slice):
                idx = np.arange(n)[spec]
            else:
                spec = np.asarray(spec)
                if spec.dtype == bool:
                    if spec.shape != (n,):
                        raise ValueError(f"axis {ax}: mask of shape "
                                         f"{spec.shape} for length {n}")
                    idx = np.flatnonzero(spec)
                else:
                    idx = spec.astype(np.int64)
            # [-n, 0) counts from the end; anything else out of range raises
            if idx.size and (idx.min() < -n or idx.max() >= n):
                raise IndexError(
                    f"axis {ax}: indices out of range for length {n}")
            specs.append(np.where(idx < 0, idx + n, idx).astype(np.int64))
        super().__init__(dim_shape, tuple(len(s) for s in specs))
        self._idx = tuple(_StaticIndex(s) for s in specs)
        self._axes = []         # (axis, slice or None, _StaticIndex)
        for ax, (idx, n) in enumerate(zip(self._idx, dim_shape)):
            if len(idx) == n and np.array_equal(idx.arr, np.arange(n)):
                continue        # the whole axis
            self._axes.append((ax, idx.as_slice(), idx))
        self._on_device = {}    # (axis, device) -> index tensor
        L = 1.0
        for s in specs:
            L *= float(np.sqrt(int(np.bincount(s).max()) if len(s) else 1))
        self._lipschitz = L
        self._name = "SubSample"

    def _index(self, ax, idx, device):
        key = (ax, device)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(idx.arr).to(device)
        return self._on_device[key]

    def apply(self, arr):
        nb = arr.ndim - self.dim_rank
        for ax, sl, idx in self._axes:
            if sl is not None:
                arr = arr[(slice(None),) * (nb + ax) + (sl,)]
            else:
                arr = arr.index_select(nb + ax,
                                       self._index(ax, idx, arr.device))
        return arr

    def adjoint(self, arr):
        nb = arr.ndim - self.codim_rank
        for ax, sl, idx in reversed(self._axes):
            d = nb + ax
            shape = list(arr.shape)
            shape[d] = self.dim_shape[ax]
            out = arr.new_zeros(shape)
            if sl is not None:
                out[(slice(None),) * d + (sl,)] = arr
            else:
                out.index_add_(d, self._index(ax, idx, arr.device), arr)
            arr = out
        return arr

    def estimate_lipschitz(self, **kw):
        return self._lipschitz

    def _expr(self):
        return (f"SubSample[{self.dim_shape}->{self.codim_shape}]",)


class Trim(LinOp):
    """Crop ``trim_width`` from each border; the adjoint pads with zeros."""

    def __init__(self, dim_shape, trim_width):
        dim_shape = as_canonical_shape(dim_shape)
        tw = _as_pad_width(trim_width, len(dim_shape))
        codim_shape = tuple(n - lo - hi for n, (lo, hi) in zip(dim_shape, tw))
        if not all(c > 0 for c in codim_shape):
            raise ValueError(f"trim {tw} leaves nothing of {dim_shape}")
        super().__init__(dim_shape, codim_shape)
        self._tw = tw
        self._lipschitz = 1.0
        self._name = "Trim"

    def apply(self, arr):
        nb = arr.ndim - self.dim_rank
        return arr[(slice(None),) * nb + tuple(
            slice(lo, n - hi) for n, (lo, hi) in zip(self.dim_shape,
                                                     self._tw))]

    def adjoint(self, arr):
        flat = []
        for lo, hi in reversed(self._tw):   # F.pad lists the last axis first
            flat += [lo, hi]
        return torch.nn.functional.pad(arr, flat)

    def estimate_lipschitz(self, **kw):
        return 1.0

    def _expr(self):
        return (f"Trim[{self._tw}]",)
