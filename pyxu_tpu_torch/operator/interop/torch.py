"""Operators from PyTorch callables (counterpart of
``pyxu_tpu/operator/interop/torch.py``).

In the port the package's arrays are torch tensors, so ``from_torch`` is
:func:`~pyxu_tpu_torch.operator.interop.source.from_source` on the
caller's callables, run on the tensors' own device with no host callback.
A missing ``grad`` (differentiable functionals) or ``adjoint`` (linear
operators) is derived by ``torch.func`` (``grad`` of the batch sum; the
``vjp`` at zero).  A callable that reaches one of the port's CUDA kernel
wrappers cannot be differentiated: the wrapper raises (``ops/_guard.py``)
and never falls back to its plain version.  ``asarray`` and ``astensor``
bring an array across as a tensor, through DLPack where it can.
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.abc.operator import Property
from pyxu_tpu_torch.operator.interop.source import from_source
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["from_torch", "asarray", "astensor"]


def _vmapped(fn, core_ndim: int):
    """``fn``, written for one sample of rank ``core_ndim``, lifted to
    leading batch axes by ``torch.func.vmap`` over the flattened batch."""
    def lifted(arr, *args):
        if arr.ndim == core_ndim:
            return fn(arr, *args)
        batch = arr.shape[: arr.ndim - core_ndim]
        flat = arr.reshape((-1,) + tuple(arr.shape[arr.ndim - core_ndim:]))
        out = torch.func.vmap(fn)(flat, *args)
        return out.reshape(batch + tuple(out.shape[1:]))
    return lifted


def from_torch(cls, dim_shape, codim_shape=None, vectorize=(),
               infer_missing: bool = True, **kwargs):
    """An operator of class ``cls`` from torch callables: ``apply=``, and
    optionally ``grad=``, ``adjoint=``, ``prox=`` (``(arr, tau)``).  The
    callables take batches over leading axes, except those named in
    ``vectorize`` (single-sample, lifted by ``torch.func.vmap``).  With
    ``infer_missing`` a missing ``grad`` or ``adjoint`` is derived by
    ``torch.func``.  Other keywords (``lipschitz=``,
    ``diff_lipschitz=``, ...) go to ``from_source``."""
    dim_shape = as_canonical_shape(dim_shape)
    props = cls.properties()
    if Property.FUNCTIONAL in props:
        codim_shape = ()
    codim = as_canonical_shape(codim_shape) if codim_shape is not None \
        else None
    apply = kwargs.pop("apply", None)
    if apply is None:
        raise ValueError("from_torch requires apply=")
    vecset = {vectorize} if isinstance(vectorize, str) else set(vectorize)
    if "apply" in vecset:
        apply = _vmapped(apply, len(dim_shape))
    for name, rank in (("grad", len(dim_shape)),
                       ("adjoint", len(codim or ()))):
        if name in vecset and name in kwargs:
            kwargs[name] = _vmapped(kwargs[name], rank)
    if infer_missing:
        if Property.DIFFERENTIABLE_FUNCTION in props and "grad" not in kwargs:
            # the batch's samples are independent: the gradient of the
            # batch sum stacks the per-sample gradients
            kwargs["grad"] = torch.func.grad(lambda x: apply(x).sum())
        if Property.LINEAR in props and "adjoint" not in kwargs:
            def adjoint(y, _rank=len(codim)):
                batch = y.shape[: y.ndim - _rank]
                x0 = torch.zeros(batch + dim_shape, dtype=y.dtype,
                                 device=y.device)
                _, vjp = torch.func.vjp(apply, x0)
                return vjp(y)[0]
            kwargs["adjoint"] = adjoint
    return from_source(cls, dim_shape, codim_shape, apply=apply, **kwargs)


def _as_tensor(obj) -> torch.Tensor:
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    try:
        return torch.from_dlpack(obj)
    except (TypeError, AttributeError, RuntimeError, BufferError):
        return torch.as_tensor(obj)


def asarray(tensor) -> torch.Tensor:
    """A tensor as the package's array: the tensor itself, detached (any
    other DLPack exporter or array-like comes across as a tensor,
    zero-copy where DLPack allows)."""
    return _as_tensor(tensor)


def astensor(arr) -> torch.Tensor:
    """The package's array (or any DLPack exporter or array-like) as a
    ``torch.Tensor``, zero-copy where DLPack allows."""
    return _as_tensor(arr)
