"""Property-typed operator hierarchy (counterpart of ``pyxu_tpu/abc/operator.py``).

The class tower and property sets follow ``pyxu_tpu``::

    Map ── Func ─────────────── ProxFunc ── ProxDiffFunc ── QuadraticFunc
     │       │                                  │                LinFunc
     └── DiffMap ── DiffFunc ───────────────────┘
           │
           └── LinOp ── SquareOp ── NormalOp ── UnitOp / SelfAdjointOp ── PosDefOp
                           └── ProjOp ── OrthProjOp

Operators are plain Python objects holding tensors (or host taps); their
methods are functions of ``(self, tensor)`` that run on the tensor's
device.  Shapes are multi-dimensional: ``dim_shape``/``codim_shape`` are
tuples and functionals have ``codim_shape == ()``; leading batch axes are
allowed.  A generic ``LinOp.adjoint`` comes from autograd (the vector-
Jacobian product of the linear ``apply``); the operators of the TV path
override it with closed forms.  ``DiffMap.jacobian`` linearises ``apply``
with ``torch.func.jvp``/``vjp``.  The stencil and NUFFT kernel wrappers
carry autograd rules whose backward is the adjoint kernel (``ops/``), so
these transforms run through them on the card; the fused TV step, a
solver step only ``CondatVu`` calls, refuses them.  The rules compose
their parts' Jacobians, so a linear part such as a Stencil is applied as
itself.
"""

from __future__ import annotations

import enum
import functools
import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import as_canonical_shape
from pyxu_tpu_torch.utils.profiler import span

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
    "UnitOp",
    "SelfAdjointOp",
    "PosDefOp",
    "ProjOp",
    "OrthProjOp",
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

    def arithmetic_methods(self) -> frozenset:
        """The instance methods this property brings (the JAX package's
        sets)."""
        data = {
            Property.CAN_EVAL: ("apply", "__call__", "lipschitz",
                                "estimate_lipschitz"),
            Property.PROXIMABLE: ("prox", "fenchel_prox", "moreau_envelope"),
            Property.DIFFERENTIABLE: ("jacobian", "diff_lipschitz",
                                      "estimate_diff_lipschitz"),
            Property.DIFFERENTIABLE_FUNCTION: ("grad",),
            Property.LINEAR: ("adjoint", "asarray", "svdvals", "pinv",
                              "gram", "cogram"),
            Property.LINEAR_SQUARE: ("trace",),
            Property.QUADRATIC: ("_quad_spec",),
        }
        return frozenset(data.get(self, ()))


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

    # -- the flat API: sizes, and outputs with a flat last axis ---------
    @property
    def dim(self) -> int:
        """The domain's size, the product of ``dim_shape``."""
        return self.dim_size

    @property
    def codim(self) -> int:
        """The co-domain's size, the product of ``codim_shape``."""
        return self.codim_size

    @property
    def shape(self) -> tuple:
        """``(codim, dim)``."""
        return (self.codim_size, self.dim_size)

    def unravel(self, arr) -> torch.Tensor:
        """A flat output ``(..., codim)`` as ``(..., *codim_shape)``."""
        arr = torch.as_tensor(arr)
        return arr.reshape(arr.shape[:-1] + tuple(self._codim_shape))

    def ravel(self, arr) -> torch.Tensor:
        """An output ``(..., *codim_shape)`` as ``(..., codim)``: the inverse
        of :meth:`unravel`."""
        arr = torch.as_tensor(arr)
        rank = len(self._codim_shape)
        batch = tuple(arr.shape[:arr.ndim - rank])
        return arr.reshape(batch + (self.codim_size,))

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

    def squeeze(self) -> "Operator":
        """Specialise a codim-1 operator to its functional class:
        Map -> Func, DiffMap -> DiffFunc, LinOp -> LinFunc."""
        if self.codim_shape == () or self.codim_size != 1:
            return self
        if self.has(Property.LINEAR):
            cls = LinFunc
        elif self.has(Property.DIFFERENTIABLE):
            cls = DiffFunc
        else:
            cls = Func
        return self.asop(cls)

    def _expr(self) -> tuple:
        """(head, *children) for expression-tree printing."""
        return (self._name,)

    def expr(self, level: int = 0, strip: bool = True) -> str:
        """The expression tree, one node a line, children indented."""
        head, *tail = self._expr()
        lines = ["  " * level + str(head)]
        for t in tail:
            if isinstance(t, Operator):
                lines.append(t.expr(level + 1, strip=False))
            else:
                lines.append("  " * (level + 1) + str(t))
        return "\n".join(lines)

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

    def __truediv__(self, other):
        from pyxu_tpu_torch.abc import arithmetic
        if isinstance(other, (int, float, np.integer, np.floating)):
            return arithmetic.scale(self, 1.0 / float(other))
        return NotImplemented

    def __pow__(self, k):
        from pyxu_tpu_torch.abc import arithmetic
        if isinstance(k, (int, np.integer)) and k >= 0:
            return arithmetic.power(self, int(k))
        return NotImplemented

    def argscale(self, scalar) -> "Operator":
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.argscale(self, float(scalar))

    def argshift(self, shift) -> "Operator":
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.argshift(self, shift)

    # -- batch helper ------------------------------------------------------
    def _map_batched(self, fn, arr, in_rank: int, out_shape: tuple):
        """Apply ``fn`` over any leading batch axes of ``arr``: the batch is
        flattened to one leading axis, ``fn`` maps ``(B, *core)`` to ``(B,
        *out_shape)`` (the JAX package vmaps a single-sample ``fn``; here
        ``fn`` takes the stacked batch, so a kernel sees it in one launch),
        and the batch shape is restored.  An unbatched input goes through
        as a batch of one."""
        batch = tuple(arr.shape[: arr.ndim - in_rank])
        core = tuple(arr.shape[arr.ndim - in_rank:])
        out = fn(arr.reshape((_math.prod(batch),) + core))
        return out.reshape(batch + tuple(out_shape))


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
        """f(x) -> f(x - data), built in the span ``op.asloss``."""
        if data is None:
            return self
        with span("op.asloss"):
            return self.argshift(-torch.as_tensor(data))


class DiffMap(Map):
    """Differentiable map."""

    @classmethod
    def properties(cls) -> frozenset:
        return Map.properties() | {Property.DIFFERENTIABLE}

    def jacobian(self, arr) -> "LinOp":
        """Jacobian at ``arr`` (unbatched), by ``torch.func.jvp``/``vjp``."""
        return _JacobianOp(self, torch.as_tensor(arr))

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

    def moreau_envelope(self, mu: float) -> "DiffFunc":
        """Moreau-Yosida smoothing of parameter ``mu``."""
        return _MoreauEnvelope(self, float(mu))


class ProxDiffFunc(ProxFunc, DiffFunc):

    @classmethod
    def properties(cls) -> frozenset:
        return ProxFunc.properties() | DiffFunc.properties()


def _t_dtype(t) -> torch.dtype:
    """The dtype a quadratic's constant ``t`` promotes with: its own, or
    for a number the default width's.  The JAX package holds ``t`` as a
    0-d array, which promotes a narrower input (a bfloat16 ``x`` gives a
    float32 value), where a 0-d torch tensor would not."""
    return t.dtype if isinstance(t, torch.Tensor) else default_fdtype()


class QuadraticFunc(ProxDiffFunc):
    r"""f(x) = (1/2) <x, Qx> + <c, x> + t with Q positive semi-definite.

    ``prox`` solves ``(I + tau Q) p = x - tau c`` by conjugate gradient
    (:func:`pyxu_tpu_torch.math.cg.cg_solve`), started at ``x``.  Per
    instance, ``_prox_rtol``, ``_prox_maxiter`` and ``_prox_precond`` (a
    callable ``(r, tau) -> M^{-1} r``) override the defaults: rtol
    ``max(100 eps(dtype), 1e-6)`` and ``min(max(2 dim_size, 20), 500)``
    iterations.
    """

    _prox_rtol = None
    _prox_maxiter = None
    _prox_precond = None
    # t is an array leaf of the JAX package's pytree even where it is a
    # Python float here (``operator/blocks.py`` homogeneity)
    _batch_scalars = ("_t",)

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
        out = quad + self._c.apply(arr) + self._t
        return out.to(torch.promote_types(out.dtype, _t_dtype(self._t)))

    def grad(self, arr):
        return self._Q.apply(arr) + self._c.grad(arr)

    def prox(self, arr, tau):
        from pyxu_tpu_torch.math.cg import cg_solve
        tau = float(tau)
        b = arr - tau * self._c.grad(arr)
        pre = self._prox_precond
        precond = None if pre is None else (lambda r: pre(r, tau))
        rtol, maxiter = self._prox_budget(arr.dtype)
        return cg_solve(lambda p: p + tau * self._Q.apply(p), b, x0=arr,
                        rtol=rtol, maxiter=maxiter, precond=precond)

    def _prox_budget(self, dtype) -> tuple:
        """The prox CG's (rtol, maxiter) at ``dtype``."""
        # an rtol below working precision never fires and burns maxiter;
        # floored at 1e-6 so that float64 does not tighten it 8 orders
        rtol = self._prox_rtol
        if rtol is None:
            rtol = max(100.0 * torch.finfo(dtype).eps, 1e-6)
        maxiter = self._prox_maxiter
        if maxiter is None:
            maxiter = min(max(2 * self.dim_size, 20), 500)
        return rtol, maxiter

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

    def jacobian(self, arr) -> "LinOp":
        return self

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

    def cogram(self) -> "SelfAdjointOp":
        """A A^T."""
        return _GramOp(self, cogram=True)

    def asarray(self, dtype=None, device=None) -> torch.Tensor:
        """The dense ``(*codim_shape, *dim_shape)`` matrix, by one batched
        apply of the basis (small operators only: tests, explicit solves).
        ``device`` is resolved as every entry point resolves it."""
        dt = default_fdtype() if dtype is None else dtype
        n = self.dim_size
        basis = torch.eye(n, dtype=dt, device=resolve_device(device))
        with torch.no_grad():
            cols = self.apply(basis.reshape((n,) + self.dim_shape))
        mat = cols.reshape(n, self.codim_size).T
        return mat.reshape(self.codim_shape + self.dim_shape)

    def pinv(self, arr, damp: float = 0.0, kwargs_init=None, **kwargs):
        """Moore-Penrose pseudo-inverse applied to ``arr``: CG
        (:func:`pyxu_tpu_torch.math.cg.cg_solve`) on the damped normal
        equations ``(A^T A + damp I) x = A^T arr``.  ``rtol`` defaults to
        ``max(100 eps(dtype), 1e-6)``, ``maxiter`` to ``min(max(2
        dim_size, 20), 1000)``; ``kwargs_init["x0"]`` warm-starts CG."""
        from pyxu_tpu_torch.math.cg import cg_solve
        b = self.adjoint(arr)
        damp = float(damp)
        gram = self.gram()
        unknown = set(kwargs) - {"rtol", "maxiter"}
        assert not unknown, f"unknown pinv kwargs: {unknown}"
        rtol = kwargs.get("rtol")
        if rtol is None:
            rtol = max(100.0 * torch.finfo(b.dtype).eps, 1e-6)
        maxiter = kwargs.get("maxiter")
        if maxiter is None:
            maxiter = min(max(2 * self.dim_size, 20), 1000)
        x0 = (kwargs_init or {}).get("x0")
        return cg_solve(lambda x: gram.apply(x) + damp * x, b, x0=x0,
                        rtol=rtol, maxiter=maxiter)

    def dagger(self, damp: float = 0.0, **kwargs) -> "LinOp":
        """The pseudo-inverse as a LinOp."""
        return _DaggerOp(self, float(damp))

    @classmethod
    def from_array(cls, A, dim_rank: int = 1, device=None) -> "LinOp":
        """Wrap a matrix ``(*codim_shape, *dim_shape)``: dense as an
        :class:`~pyxu_tpu_torch.operator.linop.base.ExplicitLinOp`, a
        ``scipy.sparse`` matrix or torch sparse tensor as a
        :class:`~pyxu_tpu_torch.operator.linop.base.SparseExplicitLinOp`
        (a tensor keeps its device; a host array goes to ``device``)."""
        from pyxu_tpu_torch.operator.linop.base import (ExplicitLinOp,
                                                        SparseExplicitLinOp,
                                                        _is_sparse)
        if _is_sparse(A):
            return SparseExplicitLinOp(A, dim_rank=dim_rank, device=device)
        return ExplicitLinOp(A, dim_rank=dim_rank, device=device)

    def to_sciop(self, dtype=None, device=None):
        """A ``scipy.sparse.linalg.LinearOperator`` on flattened vectors
        (host arrays in and out; the applies run on ``device``)."""
        import scipy.sparse.linalg as spl
        dt = default_fdtype() if dtype is None else dtype
        dev = resolve_device(device)
        np_dt = torch.empty(0, dtype=dt).numpy().dtype

        def run(fn, v, shape):
            x = torch.from_numpy(np.ascontiguousarray(v, dtype=np_dt))
            with torch.no_grad():
                y = fn(x.reshape(shape).to(dev))
            return y.cpu().numpy()

        def mv(v):
            return run(self.apply, v, self.dim_shape).ravel()

        def rmv(v):
            return run(self.adjoint, v, self.codim_shape).ravel()

        def mm(V):
            Y = run(self.apply, np.asarray(V).T, (-1,) + self.dim_shape)
            return Y.reshape(V.shape[1], -1).T

        return spl.LinearOperator(shape=(self.codim_size, self.dim_size),
                                  dtype=np_dt, matvec=mv, rmatvec=rmv,
                                  matmat=mm)


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


class UnitOp(NormalOp):
    """A A^T = A^T A = I."""

    @classmethod
    def properties(cls) -> frozenset:
        return NormalOp.properties() | {Property.LINEAR_UNITARY}

    def __init__(self, dim_shape, codim_shape=None):
        super().__init__(dim_shape, codim_shape)
        self._lipschitz = 1.0

    def estimate_lipschitz(self, **kwargs) -> float:
        return 1.0

    def pinv(self, arr, damp: float = 0.0, **kwargs):
        out = self.adjoint(arr)
        if damp != 0.0:
            out = out / (1.0 + damp)
        return out

    def dagger(self, damp: float = 0.0, **kwargs) -> "LinOp":
        from pyxu_tpu_torch.abc import arithmetic
        op = arithmetic.transpose(self)
        if damp != 0.0:
            op = arithmetic.scale(op, 1.0 / (1.0 + damp))
        return op

    def svdvals(self, k: int = 1, dtype=None, device=None, **kwargs):
        return torch.ones(k, dtype=dtype or default_fdtype(),
                          device=resolve_device(device))


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


class ProjOp(SquareOp):
    """A^2 = A."""

    @classmethod
    def properties(cls) -> frozenset:
        return SquareOp.properties() | {Property.LINEAR_IDEMPOTENT}


class OrthProjOp(ProjOp, SelfAdjointOp):
    """A^2 = A = A^T."""

    @classmethod
    def properties(cls) -> frozenset:
        return ProjOp.properties() | SelfAdjointOp.properties()

    def __init__(self, dim_shape, codim_shape=None):
        super().__init__(dim_shape, codim_shape)
        self._lipschitz = 1.0

    def estimate_lipschitz(self, **kwargs) -> float:
        return 1.0

    def gram(self):
        return self

    def cogram(self):
        return self

    def pinv(self, arr, damp: float = 0.0, **kwargs):
        out = self.apply(arr)
        if damp != 0.0:
            out = out / (1.0 + damp)
        return out

    def dagger(self, damp: float = 0.0, **kwargs) -> "LinOp":
        from pyxu_tpu_torch.abc import arithmetic
        return arithmetic.scale(self, 1.0 / (1.0 + damp)) if damp != 0.0 \
            else self


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

    def svdvals(self, k: int = 1, dtype=None, device=None, **kwargs):
        """The rank-1 spectrum ``||w||``, padded with zeros, ascending."""
        out = torch.zeros(k, dtype=dtype or default_fdtype(),
                          device=resolve_device(device))
        out[-1] = self.estimate_lipschitz(dtype=dtype, device=device)
        return out

    def asarray(self, dtype=None, device=None):
        one = torch.ones((), dtype=dtype or default_fdtype(),
                         device=resolve_device(device))
        return self.adjoint(one)


class _GramOp(SelfAdjointOp):
    """A^T A (or, with ``cogram``, A A^T): self-adjoint composition
    without wrapper chains."""

    def __init__(self, op: LinOp, cogram: bool = False):
        super().__init__(op.codim_shape if cogram else op.dim_shape)
        self._op = op
        self._cogram = bool(cogram)
        if op.lipschitz != _math.inf:
            self._lipschitz = op.lipschitz ** 2
        self._name = f"{'CoGram' if cogram else 'Gram'}[{op.name}]"

    def apply(self, arr):
        if self._cogram:
            return self._op.apply(self._op.adjoint(arr))
        return self._op.adjoint(self._op.apply(arr))

    def estimate_lipschitz(self, **kwargs) -> float:
        L = self._op.estimate_lipschitz(**kwargs)
        self._lipschitz = L * L
        return self._lipschitz

    def _expr(self):
        return ("cogram" if self._cogram else "gram", self._op)


class _JacobianOp(LinOp):
    """The Jacobian of a DiffMap at a point (unbatched): ``apply`` is
    ``torch.func.jvp`` of the map's ``apply``, ``adjoint`` its ``vjp``.  A
    batch of tangents is linearised at the point repeated along the batch
    (the map's ``apply`` takes batches; its samples are independent)."""

    def __init__(self, op: DiffMap, at: torch.Tensor):
        super().__init__(op.dim_shape, op.codim_shape)
        self._op = op
        self._at = at
        self._name = f"Jacobian[{op.name}]"

    def _primal(self, n: int, like: torch.Tensor) -> torch.Tensor:
        at = self._at.to(dtype=like.dtype, device=like.device)
        return at.expand((n,) + tuple(at.shape)).contiguous()

    def apply(self, arr):
        def fn(v):
            _, jv = torch.func.jvp(self._op.apply, (self._primal(len(v), v),),
                                   (v,))
            return jv
        return self._map_batched(fn, arr, self.dim_rank, self.codim_shape)

    def adjoint(self, arr):
        def fn(w):
            _, vjp = torch.func.vjp(self._op.apply, self._primal(len(w), w))
            (x,) = vjp(w)
            return x
        return self._map_batched(fn, arr, self.codim_rank, self.dim_shape)

    def _expr(self):
        return ("jacobian", self._op)


class _MoreauEnvelope(DiffFunc):
    r"""f^mu(x) = min_y f(y) + ||x - y||^2 / (2 mu); grad = (x - prox_{mu
    f}(x)) / mu, diff-Lipschitz 1/mu."""

    def __init__(self, func: ProxFunc, mu: float):
        assert mu > 0
        super().__init__(func.dim_shape)
        self._func = func
        self._mu = mu
        self._diff_lipschitz = 1.0 / mu
        self._name = f"MoreauEnvelope[{func.name}]"

    def apply(self, arr):
        p = self._func.prox(arr, self._mu)
        return self._func.apply(p) + _sum_core(
            (arr - p) ** 2, self.dim_rank) / (2 * self._mu)

    def grad(self, arr):
        return (arr - self._func.prox(arr, self._mu)) / self._mu

    def _expr(self):
        return (f"moreau_envelope[mu={self._mu}]", self._func)


class _DaggerOp(LinOp):
    """The Moore-Penrose pseudo-inverse of ``op`` as an operator: ``apply``
    is ``op.pinv``, ``adjoint`` the transpose's ``pinv``.  Each sample of a
    batch is solved on its own, as the JAX package's vmap does."""

    def __init__(self, op: LinOp, damp: float):
        super().__init__(op.codim_shape, op.dim_shape)
        self._op = op
        self._damp = damp
        self._name = f"Dagger[{op.name}]"

    def _each(self, fn, arr, rank):
        if arr.ndim == rank:
            return fn(arr)
        batch = arr.shape[: arr.ndim - rank]
        flat = arr.reshape((-1,) + tuple(arr.shape[arr.ndim - rank:]))
        out = torch.stack([fn(a) for a in flat])
        return out.reshape(batch + tuple(out.shape[1:]))

    def apply(self, arr):
        return self._each(lambda y: self._op.pinv(y, damp=self._damp), arr,
                          self.dim_rank)

    def adjoint(self, arr):
        from pyxu_tpu_torch.abc import arithmetic
        opT = arithmetic.transpose(self._op)
        return self._each(lambda x: opT.pinv(x, damp=self._damp), arr,
                          self.codim_rank)

    def _expr(self):
        return (f"dagger[damp={self._damp}]", self._op)


@functools.cache
def core_operators() -> tuple:
    """The 16 core classes of the tower."""
    return (Map, Func, DiffMap, DiffFunc, ProxFunc, ProxDiffFunc,
            QuadraticFunc, LinOp, LinFunc, SquareOp, NormalOp, UnitOp,
            SelfAdjointOp, PosDefOp, ProjOp, OrthProjOp)


def infer_operator_class(properties: frozenset) -> type:
    """Tightest core class whose property set is contained in ``properties``."""
    properties = frozenset(properties)
    candidates = [c for c in core_operators() if c.properties() <= properties]
    if not candidates:
        raise ValueError(f"no operator class matches properties {properties}")
    return max(candidates, key=lambda c: len(c.properties()))
