"""Property-typed operator hierarchy (counterpart of ``pyxu_tpu/abc/operator.py``).

The class tower and property sets follow ``pyxu_tpu``::

    Map ── Func ─────────────── ProxFunc ── ProxDiffFunc ── QuadraticFunc
     │       │                                  │                LinFunc
     └── DiffMap ── DiffFunc ───────────────────┘
           │
           └── LinOp ── SquareOp ── NormalOp ── SelfAdjointOp ── PosDefOp

Operators are plain Python objects holding tensors (or host taps); their
methods are functions of ``(self, tensor)`` that run on the tensor's
device.  Shapes are multi-dimensional: ``dim_shape``/``codim_shape`` are
tuples and functionals have ``codim_shape == ()``; leading batch axes are
allowed.  A generic ``LinOp.adjoint`` comes from autograd (the vector-
Jacobian product of the linear ``apply``); the operators of the TV path
override it with closed forms.
"""

from __future__ import annotations

import enum
import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = [
    "Property",
    "Operator",
    "Map",
    "Func",
    "DiffMap",
    "DiffFunc",
    "ProxFunc",
    "ProxDiffFunc",
    "QuadraticFunc",
    "LinOp",
    "LinFunc",
    "SquareOp",
    "NormalOp",
    "SelfAdjointOp",
    "PosDefOp",
    "core_operators",
    "infer_operator_class",
]


class Property(enum.Enum):
    """Mathematical properties an operator class carries."""

    CAN_EVAL = enum.auto()
    FUNCTIONAL = enum.auto()
    PROXIMABLE = enum.auto()
    DIFFERENTIABLE = enum.auto()
    DIFFERENTIABLE_FUNCTION = enum.auto()
    LINEAR = enum.auto()
    LINEAR_SQUARE = enum.auto()
    LINEAR_NORMAL = enum.auto()
    LINEAR_IDEMPOTENT = enum.auto()
    LINEAR_SELF_ADJOINT = enum.auto()
    LINEAR_POSITIVE_DEFINITE = enum.auto()
    LINEAR_UNITARY = enum.auto()
    QUADRATIC = enum.auto()


def _sum_core(arr: torch.Tensor, rank: int) -> torch.Tensor:
    """Sum over the trailing ``rank`` axes (a no-op for rank 0)."""
    return arr.sum(dim=tuple(range(-rank, 0))) if rank else arr


def _autograd_grad(op, arr: torch.Tensor) -> torch.Tensor:
    """Batched gradient of ``sum(op.apply)`` by autograd (batch elements are
    independent, so the batch-sum's gradient stacks the per-sample ones)."""
    with torch.enable_grad():
        x = arr.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(op.apply(x).sum(), x)
    return g


class Operator:
    """Abstract base of every map, functional and linear operator."""

    def __init__(self, dim_shape, codim_shape):
        self._dim_shape = as_canonical_shape(dim_shape)
        self._codim_shape = as_canonical_shape(codim_shape)
        self._lipschitz = _math.inf
        self._diff_lipschitz = _math.inf
        self._name = type(self).__name__

    # -- shapes ----------------------------------------------------------
    @property
    def dim_shape(self) -> tuple:
        return self._dim_shape

    @property
    def codim_shape(self) -> tuple:
        return self._codim_shape

    @property
    def dim_size(self) -> int:
        return int(np.prod(self._dim_shape)) if self._dim_shape else 1

    @property
    def codim_size(self) -> int:
        return int(np.prod(self._codim_shape)) if self._codim_shape else 1

    @property
    def dim_rank(self) -> int:
        return len(self._dim_shape)

    @property
    def codim_rank(self) -> int:
        return len(self._codim_shape)

    @property
    def name(self) -> str:
        return self._name

    # -- properties --------------------------------------------------------
    @classmethod
    def properties(cls) -> frozenset:
        return frozenset()

    def has(self, *props: Property) -> bool:
        return frozenset(props) <= self.properties()

    def asop(self, cast_to: type) -> "Operator":
        """Recast to another operator class (see ``arithmetic.cast_op``)."""
        from pyxu_tpu_torch.abc.arithmetic import cast_op
        return cast_op(self, cast_to)

    def __repr__(self) -> str:
        return f"{self._name}(dim={self.dim_shape}, codim={self.codim_shape})"

    # -- arithmetic (delegates to the rule engine) -------------------------
    def __add__(self, other):
        from pyxu_tpu_torch.abc import arithmetic
        if not isinstance(other, Operator):
            return NotImplemented
        return arithmetic.add(self, other)

    def __sub__(self, other):
        from pyxu_tpu_torch.abc import arithmetic
        if not isinstance(other, Operator):
            return NotImplemented
        return arithmetic.add(self, arithmetic.scale(other, -1.0))

    def __neg__(self):
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.scale(self, -1.0)

    def __mul__(self, other):
        from pyxu_tpu_torch.abc import arithmetic
        if isinstance(other, Operator):
            return arithmetic.compose(self, other)
        if isinstance(other, (int, float, np.integer, np.floating)):
            return arithmetic.scale(self, float(other))
        return NotImplemented

    def __rmul__(self, other):
        from pyxu_tpu_torch.abc import arithmetic
        if isinstance(other, (int, float, np.integer, np.floating)):
            return arithmetic.scale(self, float(other))
        return NotImplemented

    def argshift(self, shift) -> "Operator":
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.argshift(self, shift)


class Map(Operator):
    """Anything evaluable: f : R^dim_shape -> R^codim_shape."""

    @classmethod
    def properties(cls) -> frozenset:
        return frozenset({Property.CAN_EVAL})

    def apply(self, arr):
        raise NotImplementedError(f"{self._name}.apply")

    def __call__(self, arr):
        return self.apply(arr)

    @property
    def lipschitz(self) -> float:
        """Cached Lipschitz upper bound; +inf if unknown."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, L: float):
        self._lipschitz = float(L)

    def estimate_lipschitz(self, **kwargs) -> float:
        if _math.isfinite(self._lipschitz):
            return self._lipschitz      # a declared constant is an estimate
        raise NotImplementedError(
            f"{self._name}: no generic Lipschitz estimator for non-linear "
            "maps")


class Func(Map):
    """Real-valued functional (``codim_shape == ()``)."""

    @classmethod
    def properties(cls) -> frozenset:
        return Map.properties() | {Property.FUNCTIONAL}

    def __init__(self, dim_shape, codim_shape=()):
        if as_canonical_shape(codim_shape) not in ((), (1,)):
            raise ValueError("functionals have scalar codomain")
        super().__init__(dim_shape, ())

    def asloss(self, data=None) -> "Func":
        """f(x) -> f(x - data)."""
        if data is None:
            return self
        return self.argshift(-torch.as_tensor(data))


class DiffMap(Map):
    """Differentiable map."""

    @classmethod
    def properties(cls) -> frozenset:
        return Map.properties() | {Property.DIFFERENTIABLE}

    @property
    def diff_lipschitz(self) -> float:
        return self._diff_lipschitz

    @diff_lipschitz.setter
    def diff_lipschitz(self, dL: float):
        self._diff_lipschitz = float(dL)

    def estimate_diff_lipschitz(self, **kwargs) -> float:
        if _math.isfinite(self._diff_lipschitz):
            return self._diff_lipschitz  # a declared constant is an estimate
        raise NotImplementedError(
            f"{self._name}: no generic diff-Lipschitz estimator for "
            "non-linear maps")


class DiffFunc(DiffMap, Func):
    """Differentiable functional with a gradient."""

    @classmethod
    def properties(cls) -> frozenset:
        return DiffMap.properties() | Func.properties() | {
            Property.DIFFERENTIABLE_FUNCTION}

    def __init__(self, dim_shape, codim_shape=()):
        Func.__init__(self, dim_shape, codim_shape)

    def grad(self, arr):
        return _autograd_grad(self, arr)


class ProxFunc(Func):
    """Proximable functional."""

    @classmethod
    def properties(cls) -> frozenset:
        return Func.properties() | {Property.PROXIMABLE}

    def prox(self, arr, tau):
        r"""prox_{tau f}(arr) = argmin_y f(y) + ||y - arr||^2 / (2 tau)."""
        raise NotImplementedError(f"{self._name}.prox")

    def fenchel_prox(self, arr, sigma):
        r"""prox of the convex conjugate, by Moreau's identity:
        prox_{sigma f*}(x) = x - sigma prox_{f/sigma}(x/sigma)."""
        return arr - sigma * self.prox(arr / sigma, 1.0 / sigma)


class ProxDiffFunc(ProxFunc, DiffFunc):

    @classmethod
    def properties(cls) -> frozenset:
        return ProxFunc.properties() | DiffFunc.properties()


class QuadraticFunc(ProxDiffFunc):
    r"""f(x) = (1/2) <x, Qx> + <c, x> + t with Q positive semi-definite.

    ``prox`` (a conjugate-gradient solve in ``pyxu_tpu``) is not ported yet:
    the TV path never calls it.
    """

    @classmethod
    def properties(cls) -> frozenset:
        return ProxDiffFunc.properties() | {Property.QUADRATIC}

    def __init__(self, dim_shape, codim_shape=(), Q=None, c=None, t=0.0):
        super().__init__(dim_shape, codim_shape)
        from pyxu_tpu_torch.operator.linop.base import IdentityOp, NullFunc
        self._Q = IdentityOp(dim_shape) if Q is None else Q
        self._c = NullFunc(dim_shape) if c is None else c
        self._t = t
        self._lipschitz = _math.inf
        self._diff_lipschitz = self._Q.lipschitz

    def _quad_spec(self):
        return (self._Q, self._c, self._t)

    def apply(self, arr):
        quad = 0.5 * _sum_core(arr * self._Q.apply(arr), self.dim_rank)
        return quad + self._c.apply(arr) + self._t

    def grad(self, arr):
        return self._Q.apply(arr) + self._c.grad(arr)

    def estimate_diff_lipschitz(self, **kwargs) -> float:
        self._diff_lipschitz = self._Q.estimate_lipschitz(**kwargs)
        return self._diff_lipschitz


class LinOp(DiffMap):
    """Linear operator."""

    @classmethod
    def properties(cls) -> frozenset:
        return DiffMap.properties() | {Property.LINEAR}

    def __init__(self, dim_shape, codim_shape):
        super().__init__(dim_shape, codim_shape)
        self._diff_lipschitz = 0.0

    def adjoint(self, arr):
        """Exact adjoint as the vector-Jacobian product of ``apply``."""
        batch = arr.shape[: arr.ndim - self.codim_rank]
        with torch.enable_grad():
            x = torch.zeros(batch + self.dim_shape, dtype=arr.dtype,
                            device=arr.device, requires_grad=True)
            (g,) = torch.autograd.grad(self.apply(x), x, grad_outputs=arr)
        return g

    @property
    def T(self) -> "LinOp":
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.transpose(self)

    def estimate_diff_lipschitz(self, **kwargs) -> float:
        """Linear maps have constant Jacobians: exactly 0."""
        self._diff_lipschitz = 0.0
        return 0.0

    def estimate_lipschitz(self, method: str = "power", generator=None,
                           maxiter: int = 64, **kwargs) -> float:
        """Spectral-norm estimate.  ``power``: power iteration on the Gram;
        ``trace``: the Frobenius bound sqrt(tr(A^T A)) by Hutch++.
        ``kwargs`` (``dtype``, ``device``) go to :mod:`pyxu_tpu_torch.math.
        linalg`."""
        from pyxu_tpu_torch.math import linalg
        if method == "power":
            L = linalg.spectral_norm(self, generator=generator,
                                     maxiter=maxiter, **kwargs)
        elif method == "trace":
            L = _math.sqrt(max(linalg.hutchpp(self.gram(),
                                              generator=generator, **kwargs),
                               0.0))
        else:
            raise ValueError(f"method {method!r} not in ('power', 'trace')")
        self._lipschitz = float(L)
        return self._lipschitz

    def svdvals(self, k: int = 1, generator=None, maxiter: int = 96,
                **kwargs):
        """Top-k singular values in ascending order."""
        from pyxu_tpu_torch.math import linalg
        return linalg.svdvals(self, k=k, generator=generator,
                              maxiter=maxiter, **kwargs)

    def gram(self) -> "SelfAdjointOp":
        """A^T A."""
        return _GramOp(self)


class SquareOp(LinOp):
    """Endomorphism: dim_shape == codim_shape."""

    @classmethod
    def properties(cls) -> frozenset:
        return LinOp.properties() | {Property.LINEAR_SQUARE}

    def __init__(self, dim_shape, codim_shape=None):
        codim_shape = dim_shape if codim_shape is None else codim_shape
        if as_canonical_shape(dim_shape) != as_canonical_shape(codim_shape):
            raise ValueError(f"square operator with dim {dim_shape} != "
                             f"codim {codim_shape}")
        super().__init__(dim_shape, codim_shape)

    def trace(self, method: str = "explicit", **kwargs) -> float:
        """Trace, exact (basis probing) or by Hutch++."""
        from pyxu_tpu_torch.math import linalg
        if method in ("explicit", "exact"):
            return linalg.trace(self, **kwargs)
        return linalg.hutchpp(self, **kwargs)


class NormalOp(SquareOp):
    """A A^T = A^T A."""

    @classmethod
    def properties(cls) -> frozenset:
        return SquareOp.properties() | {Property.LINEAR_NORMAL}


class SelfAdjointOp(NormalOp):
    """A = A^T."""

    @classmethod
    def properties(cls) -> frozenset:
        return NormalOp.properties() | {Property.LINEAR_SELF_ADJOINT}

    def adjoint(self, arr):
        return self.apply(arr)


class PosDefOp(SelfAdjointOp):
    """<x, Ax> > 0."""

    @classmethod
    def properties(cls) -> frozenset:
        return SelfAdjointOp.properties() | {Property.LINEAR_POSITIVE_DEFINITE}


class LinFunc(ProxDiffFunc, LinOp):
    """Linear functional f(x) = <w, x>."""

    @classmethod
    def properties(cls) -> frozenset:
        return ProxDiffFunc.properties() | LinOp.properties()

    def __init__(self, dim_shape, codim_shape=()):
        ProxDiffFunc.__init__(self, dim_shape, codim_shape)
        self._diff_lipschitz = 0.0

    def _w(self, like):
        return self.adjoint(torch.ones((), dtype=like.dtype, device=like.device))

    def grad(self, arr):
        """Constant gradient w = adjoint(1), broadcast over batch axes."""
        return self._w(arr).expand(arr.shape)

    def prox(self, arr, tau):
        return arr - tau * self._w(arr)

    def fenchel_prox(self, arr, sigma):
        return self._w(arr).expand(arr.shape)

    def estimate_lipschitz(self, dtype=None, device=None, **kwargs) -> float:
        """||w||_2, exactly."""
        from pyxu_tpu_torch.info.dtypes import default_fdtype
        one = torch.ones((), dtype=dtype or default_fdtype(), device=device)
        self._lipschitz = float(torch.linalg.vector_norm(self._w(one)))
        return self._lipschitz


class _GramOp(SelfAdjointOp):
    """A^T A: self-adjoint composition without wrapper chains (the
    ``cogram`` A A^T of the reference is not ported yet)."""

    def __init__(self, op: LinOp):
        super().__init__(op.dim_shape)
        self._op = op
        if op.lipschitz != _math.inf:
            self._lipschitz = op.lipschitz ** 2
        self._name = f"Gram[{op.name}]"

    def apply(self, arr):
        return self._op.adjoint(self._op.apply(arr))

    def estimate_lipschitz(self, **kwargs) -> float:
        L = self._op.estimate_lipschitz(**kwargs)
        self._lipschitz = L * L
        return self._lipschitz


def core_operators() -> tuple:
    """The core classes of the port's tower."""
    return (Map, Func, DiffMap, DiffFunc, ProxFunc, ProxDiffFunc,
            QuadraticFunc, LinOp, LinFunc, SquareOp, NormalOp, SelfAdjointOp,
            PosDefOp)


def infer_operator_class(properties: frozenset) -> type:
    """Tightest core class whose property set is contained in ``properties``."""
    properties = frozenset(properties)
    candidates = [c for c in core_operators() if c.properties() <= properties]
    if not candidates:
        raise ValueError(f"no operator class matches properties {properties}")
    return max(candidates, key=lambda c: len(c.properties()))
