"""Operators built from plain callables (counterpart of
``pyxu_tpu/operator/interop/source.py``).

``from_source(cls, dim_shape, codim_shape, apply=..., adjoint=..., ...)``
returns an instance of a composite class ``Source[<cls>]`` whose methods
call the given callables; a method that was not given falls back to the
class's own (an autograd adjoint for a ``LinOp``, an autograd gradient for
a ``DiffFunc``, the quadratic spec for ``grad``/``prox`` of a
``QuadraticFunc``).  The callables take and return tensors.
"""

from __future__ import annotations

import functools

import torch

from pyxu_tpu_torch.abc.operator import Operator, Property
from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["from_source"]

_FORWARDABLE = (
    "apply", "adjoint", "grad", "prox", "jacobian", "_quad_spec",
    "estimate_lipschitz", "estimate_diff_lipschitz", "pinv", "trace",
    "svdvals", "asarray",
)


class SourceMixin:
    """Delegates the arithmetic methods to the callables in ``_methods``."""

    def _src(self, name):
        fn = self._methods.get(name)
        if fn is None:
            raise NotImplementedError(f"{self._name}.{name} not provided")
        return fn

    def apply(self, arr):
        return self._src("apply")(arr)

    def adjoint(self, arr):
        fn = self._methods.get("adjoint")
        return super().adjoint(arr) if fn is None else fn(arr)

    def grad(self, arr):
        fn = self._methods.get("grad")
        if fn is not None:
            return fn(arr)
        qs = self._methods.get("_quad_spec")
        if qs is not None:       # grad = Qx + c, from the quadratic spec
            Q, c, _ = qs()
            return Q.apply(arr) + c.grad(arr)
        return super().grad(arr)

    def prox(self, arr, tau):
        fn = self._methods.get("prox")
        if fn is not None:
            return fn(arr, tau)
        qs = self._methods.get("_quad_spec")
        if qs is None:
            raise NotImplementedError(f"{self._name}.prox not provided")
        from pyxu_tpu_torch.abc.operator import QuadraticFunc
        Q, c, t = qs()
        return QuadraticFunc(self.dim_shape, Q=Q, c=c, t=t).prox(arr, tau)

    def jacobian(self, arr):
        fn = self._methods.get("jacobian")
        return super().jacobian(arr) if fn is None else fn(arr)

    def _quad_spec(self):
        fn = self._methods.get("_quad_spec")
        return super()._quad_spec() if fn is None else fn()

    def pinv(self, arr, damp: float = 0.0, **kw):
        fn = self._methods.get("pinv")
        if fn is None:
            return super().pinv(arr, damp=damp, **kw)
        return fn(arr, damp=damp, **kw)

    def trace(self, **kw):
        fn = self._methods.get("trace")
        return super().trace(**kw) if fn is None else fn(**kw)

    def svdvals(self, k: int = 1, **kw):
        fn = self._methods.get("svdvals")
        return super().svdvals(k=k, **kw) if fn is None else fn(k=k, **kw)

    def asarray(self, dtype=None, device=None):
        fn = self._methods.get("asarray")
        if fn is None:
            return super().asarray(dtype=dtype, device=device)
        return fn(dtype=dtype)

    def estimate_lipschitz(self, **kw):
        fn = self._methods.get("estimate_lipschitz")
        if fn is None:
            return super().estimate_lipschitz(**kw)
        self._lipschitz = fn(**kw)
        return self._lipschitz

    def estimate_diff_lipschitz(self, **kw):
        fn = self._methods.get("estimate_diff_lipschitz")
        if fn is None:
            return super().estimate_diff_lipschitz(**kw)
        self._diff_lipschitz = fn(**kw)
        return self._diff_lipschitz

    def _expr(self):
        return (self._name,)


def _coerce(x):
    """A floating tensor cast to the policy's width (complex to the
    matching complex width); anything else as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.is_complex():
        return x.to(torch.complex128 if default_fdtype() == torch.float64
                    else torch.complex64)
    return x.to(default_fdtype())


def _coerced(fn):
    """``fn`` with its tensor arguments and output cast to the policy's
    width."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        return _coerce(fn(*(_coerce(a) for a in args), **kw))
    return wrapped


def _batched(fn, core_ndim: int):
    """``fn``, written for one sample of rank ``core_ndim``, lifted to
    leading batch axes: one call a sample, stacked."""
    @functools.wraps(fn)
    def wrapped(arr, *args, **kw):
        if arr.ndim < core_ndim:
            raise ValueError(f"input rank {arr.ndim} < core rank {core_ndim}")
        if arr.ndim == core_ndim:
            return fn(arr, *args, **kw)
        batch = arr.shape[: arr.ndim - core_ndim]
        flat = arr.reshape((-1,) + tuple(arr.shape[arr.ndim - core_ndim:]))
        out = torch.stack([fn(a, *args, **kw) for a in flat])
        return out.reshape(batch + tuple(out.shape[1:]))
    return wrapped


@functools.cache
def _source_class(klass: type) -> type:
    return type(f"Source[{klass.__name__}]", (SourceMixin, klass), {})


def from_source(cls, dim_shape, codim_shape=None, vectorize=(), embed=None,
                enforce_precision=(), **kwargs) -> Operator:
    """An operator of class ``cls`` from plain callables.

    ``dim_shape``/``codim_shape``: the shapes (``()`` for a functional,
    whatever is given).  ``vectorize``: names among ``apply``, ``grad`` and
    ``adjoint`` whose callables take one sample; they are lifted to
    leading batch axes.  ``embed``: attributes set on the operator as they
    are.  ``enforce_precision``: names of given callables whose tensor
    arguments and output are cast to the policy's width.  ``kwargs``:
    ``apply=...``, ``adjoint=...``, ``grad=...``, ``prox=...``,
    ``jacobian=...``, ``_quad_spec=...``, ``estimate_lipschitz=...``,
    ``pinv``, ``trace``, ``svdvals``, ``asarray``, and the constants
    ``lipschitz=float``, ``diff_lipschitz=float``.
    """
    dim_shape = as_canonical_shape(dim_shape)
    lipschitz = kwargs.pop("lipschitz", None)
    diff_lipschitz = kwargs.pop("diff_lipschitz", None)
    methods = {k: v for k, v in kwargs.items() if k in _FORWARDABLE}
    unknown = set(kwargs) - set(methods)
    assert not unknown, f"unknown from_source kwargs: {unknown}"

    epset = {enforce_precision} if isinstance(enforce_precision, str) \
        else set(enforce_precision)
    assert epset <= set(methods), \
        "enforce_precision can only wrap callables provided to from_source; " \
        f"not provided: {epset - set(methods)}"
    for name in epset:
        methods[name] = _coerced(methods[name])

    op = object.__new__(_source_class(cls))
    if Property.FUNCTIONAL in cls.properties():
        codim_shape = ()
    assert codim_shape is not None, "codim_shape required for non-functionals"
    Operator.__init__(op, dim_shape, codim_shape)

    vecset = {vectorize} if isinstance(vectorize, str) else set(vectorize)
    assert vecset <= {"apply", "grad", "adjoint"}, \
        "vectorize supports single-array methods only"
    for name in vecset & set(methods):
        in_rank = len(dim_shape) if name in ("apply", "grad") else \
            len(as_canonical_shape(codim_shape))
        methods[name] = _batched(methods[name], in_rank)

    op._methods = methods
    op._name = f"Source[{cls.__name__}]"
    if lipschitz is not None:
        op._lipschitz = float(lipschitz)
    if diff_lipschitz is not None:
        op._diff_lipschitz = float(diff_lipschitz)
    for k, v in (embed or {}).items():
        setattr(op, k, v)
    return op
