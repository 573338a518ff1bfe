r"""Multi-dimensional DFT operator on ``torch.fft`` (counterpart of
``pyxu_tpu/operator/linop/fft.py``).

Unnormalised DFT over ``axes`` of the spatial shape::

    A x[k] = sum_n x[n] exp(-2j pi <n/N, k>),   A^* = N ifft,

so ``A^* A = N I`` (the gram), every singular value is ``sqrt(N)`` and
``pinv = A^* / N``, with N the product of the transformed axes' sizes.
Complex arrays ride as a trailing axis of size 2
(:mod:`pyxu_tpu_torch.utils.complex`); batches over leading axes.
"""

from __future__ import annotations

import math as _math

import torch

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.operator.linop.base import HomothetyOp
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.complex import view_as_complex, view_as_real
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["FFT"]


class FFT(LinOp):
    """DFT over ``axes`` (default: all) of ``dim_shape``, the spatial shape
    without the trailing 2.

    ``real=True``: the domain is real ``(*dim_shape)`` and the codomain
    ``(*dim_shape, 2)``; else both are ``(*dim_shape, 2)``.
    """

    def __init__(self, dim_shape, axes=None, real: bool = False):
        sp = as_canonical_shape(dim_shape)
        D = len(sp)
        raw = tuple(range(D)) if axes is None else (
            tuple(axes) if isinstance(axes, (tuple, list)) else (axes,))
        axes = tuple(sorted({a % D for a in raw}))
        if len(axes) != len(raw):
            raise ValueError(f"axes {raw}: duplicate or aliased FFT axes")
        self._sp = sp
        self._axes = axes
        self._real = bool(real)
        super().__init__(sp if real else sp + (2,), sp + (2,))
        self._N = _math.prod(sp[a] for a in axes)
        self._lipschitz = _math.sqrt(self._N)
        self._name = "FFT"

    def _dims(self, zndim: int) -> tuple:
        """The complex array's FFT axes, counted from its trailing spatial
        axes (leading axes are a batch)."""
        return tuple(zndim - len(self._sp) + a for a in self._axes)

    def apply(self, arr):
        z = arr if self._real else view_as_complex(arr)
        return view_as_real(torch.fft.fftn(z, dim=self._dims(z.ndim)))

    def adjoint(self, arr):
        z = view_as_complex(arr)
        out = torch.fft.ifftn(z, dim=self._dims(z.ndim), norm="forward")
        return out.real.contiguous() if self._real else view_as_real(out)

    def estimate_lipschitz(self, **kwargs) -> float:
        return self._lipschitz

    def svdvals(self, k: int = 1, dtype=None, device=None, **kwargs):
        """``k`` copies of ``sqrt(N)``, on ``device`` (resolved as every
        entry point resolves it)."""
        return torch.full((k,), _math.sqrt(self._N),
                          dtype=dtype or default_fdtype(),
                          device=resolve_device(device))

    def gram(self):
        """``A^* A = N I``, for a real domain too."""
        return HomothetyOp(self.dim_shape, float(self._N))

    def cogram(self):
        """``A A^* = N I`` on a complex domain.  With ``real=True`` it is N
        times the projection onto conjugate-symmetric fields, which no
        homothety represents: the generic composition."""
        if self._real:
            return super().cogram()
        return HomothetyOp(self.codim_shape, float(self._N))

    def _expr(self):
        return (f"FFT[axes={self._axes}, real={self._real}]",)

    def pinv(self, arr, damp: float = 0.0, **kwargs):
        """``A^* arr / (N + damp)``."""
        return self.adjoint(arr) / (self._N + damp)

    def dagger(self, damp: float = 0.0, **kwargs):
        """The pseudo-inverse as an operator, ``A^T / (N + damp)``."""
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.scale(arithmetic.transpose(self),
                                1.0 / (self._N + damp))
