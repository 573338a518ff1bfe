"""Runtime precision policy (counterpart of ``pyxu_tpu/info/dtypes.py``).

``Precision(width)`` is a context manager that sets the default real width
used where no dtype is given.  The port carries f32 and f64; bfloat16 is a
storage format of the fused TV kernels, not a policy width.
"""

from __future__ import annotations

import contextlib
import enum
import threading

import torch

__all__ = [
    "Width",
    "Precision",
    "default_fdtype",
    "set_default_width",
    "getPrecision",
    "atol_for",
]


class Width(enum.Enum):
    """Real floating-point widths."""

    SINGLE = torch.float32
    DOUBLE = torch.float64

    @property
    def eps(self) -> float:
        return float(torch.finfo(self.value).eps)


_state = threading.local()


def _width() -> Width:
    return getattr(_state, "width", Width.SINGLE)


def set_default_width(width: Width) -> None:
    _state.width = width


def default_fdtype() -> torch.dtype:
    """Default real dtype for newly built arrays."""
    return _width().value


def getPrecision() -> Width:
    return _width()


class Precision(contextlib.AbstractContextManager):
    """Scoped default-precision override.

    >>> with Precision(Width.DOUBLE):
    ...     op = SquaredL2Norm(dim_shape=(8,))
    """

    def __init__(self, width: Width = Width.SINGLE):
        self._width = width
        self._prev = None

    def __enter__(self):
        self._prev = _width()
        set_default_width(self._width)
        return self

    def __exit__(self, *exc):
        set_default_width(self._prev)
        return False


def atol_for(dtype) -> float:
    """Conformance tolerance per dtype (2e-4 at f32, 1e-8 at f64)."""
    return {
        torch.bfloat16: 1e-2,
        torch.float32: 2e-4,
        torch.float64: 1e-8,
    }[dtype]
