"""Runtime precision policy (counterpart of ``pyxu_tpu/info/dtypes.py``).

``Precision(width)`` is a context manager that sets the default real width
used where no dtype is given; ``default_cdtype`` is its complex pair.  The
port carries f32 and f64; bfloat16 is a storage format of the fused TV
kernels, not a policy width.  ``coerce``, ``enforce_precision`` and
``EnforcePrecision`` cast arrays to the current width, as the JAX package's
do.

``enable_x64`` has no counterpart: torch holds float32 and float64 side by
side in one process, with no global switch to turn on first.
``lowered_matmul_precision`` maps the JAX package's matmul-precision names
to torch's TF32 switches, which the package turns off at import.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import inspect
import threading

import torch

__all__ = [
    "Width",
    "CWidth",
    "Precision",
    "default_fdtype",
    "default_cdtype",
    "set_default_width",
    "lowered_matmul_precision",
    "coerce",
    "enforce_precision",
    "EnforcePrecision",
    "getPrecision",
    "getCoerceState",
    "atol_for",
]


class Width(enum.Enum):
    """Real floating-point widths."""

    SINGLE = torch.float32
    DOUBLE = torch.float64

    @property
    def complex(self) -> "CWidth":
        return CWidth.DOUBLE if self is Width.DOUBLE else CWidth.SINGLE

    @property
    def eps(self) -> float:
        return float(torch.finfo(self.value).eps)


class CWidth(enum.Enum):
    """Complex floating-point widths."""

    SINGLE = torch.complex64
    DOUBLE = torch.complex128

    @property
    def real(self) -> Width:
        return Width.SINGLE if self is CWidth.SINGLE else Width.DOUBLE


_state = threading.local()


def _width() -> Width:
    return getattr(_state, "width", Width.SINGLE)


def set_default_width(width: Width) -> None:
    _state.width = width


def default_fdtype() -> torch.dtype:
    """Default real dtype for newly built arrays."""
    return _width().value


def default_cdtype() -> torch.dtype:
    """Default complex dtype, the pair of :func:`default_fdtype`."""
    return _width().complex.value


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


# the JAX package's matmul-precision names that keep full f32 products
_FULL = ("highest", "float32")


@contextlib.contextmanager
def lowered_matmul_precision(precision: str = "default"):
    """Allow TF32 matmuls and cuDNN convolutions in the block (any
    precision name but ``"highest"``/``"float32"``, which keep them off);
    the switches are restored on exit."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    lowered = str(precision).lower() not in _FULL
    torch.backends.cuda.matmul.allow_tf32 = lowered
    torch.backends.cudnn.allow_tf32 = lowered
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def getCoerceState() -> bool:
    """Whether :func:`coerce` currently casts."""
    return getattr(_state, "coerce", True)


class EnforcePrecision(contextlib.AbstractContextManager):
    """Scoped toggle of precision coercion: inside
    ``EnforcePrecision(False)``, :func:`coerce` and the methods wrapped by
    :func:`enforce_precision` pass arrays through unchanged."""

    def __init__(self, state: bool = True):
        self._new = bool(state)
        self._prev = None

    def __enter__(self):
        self._prev = getCoerceState()
        _state.coerce = self._new
        return self

    def __exit__(self, *exc):
        _state.coerce = self._prev
        return False


def coerce(arr):
    """``arr`` as a tensor at the current width: complex to
    :func:`default_cdtype`, anything else to :func:`default_fdtype`.  A
    tensor keeps its device; a no-op inside ``EnforcePrecision(False)``."""
    arr = torch.as_tensor(arr)
    if not getCoerceState():
        return arr
    if arr.is_complex():
        return arr.to(default_cdtype())
    return arr.to(default_fdtype())


def enforce_precision(i=(), o: bool = True):
    """Decorator that coerces the arguments named in ``i`` and (``o``) the
    output to the current width.

    >>> @enforce_precision(i="arr")
    ... def apply(self, arr): ...
    """
    names = (i,) if isinstance(i, str) else tuple(i)

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            ba = sig.bind(*args, **kwargs)
            for n in names:
                if ba.arguments.get(n) is not None:
                    ba.arguments[n] = coerce(ba.arguments[n])
            out = fn(*ba.args, **ba.kwargs)
            return coerce(out) if o else out

        return wrapped

    return deco


def atol_for(dtype) -> float:
    """Conformance tolerance per dtype (2e-4 at f32, 1e-8 at f64)."""
    return {
        torch.bfloat16: 1e-2,
        torch.float32: 2e-4,
        torch.float64: 1e-8,
        torch.complex64: 2e-4,
        torch.complex128: 1e-8,
    }[dtype]
