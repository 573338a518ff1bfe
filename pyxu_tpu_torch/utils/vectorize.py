"""Batching helpers (counterpart of ``pyxu_tpu/utils/vectorize.py``).

The JAX package maps a single-sample function over stacking dims with
``jax.vmap``.  The port's kernel wrappers refuse ``torch.func``
transforms, so here the batch is written out: the leading axes are
flattened to one, the function runs on each sample, and the results are
stacked.
"""

from __future__ import annotations

import functools
import inspect

import torch

__all__ = ["batched_over", "flatten_batch", "unflatten_batch", "vectorize"]


def flatten_batch(arr, core_ndim: int):
    """Collapse all leading batch axes into one; returns (arr2,
    batch_shape)."""
    arr = torch.as_tensor(arr)
    if core_ndim == 0:
        batch_shape = tuple(arr.shape)
        return arr.reshape((-1,) if arr.numel() else (0,)), batch_shape
    batch_shape = tuple(arr.shape[: arr.ndim - core_ndim])
    core_shape = tuple(arr.shape[arr.ndim - core_ndim:])
    return arr.reshape((-1,) + core_shape), batch_shape


def unflatten_batch(arr, batch_shape: tuple):
    """Inverse of :func:`flatten_batch` on the result's leading axis."""
    return arr.reshape(tuple(batch_shape) + tuple(arr.shape[1:]))


def _each(fn, flat):
    """``fn`` on each sample of the leading axis, stacked."""
    return torch.stack([fn(a) for a in flat])


def batched_over(fn, core_ndim: int):
    """Lift ``fn`` (defined on a single ``core_ndim``-rank sample) to
    accept arbitrary leading batch dims."""

    def wrapped(arr, *args, **kwargs):
        arr = torch.as_tensor(arr)
        if arr.ndim < core_ndim:
            raise ValueError(
                f"input rank {arr.ndim} < core rank {core_ndim}")
        if arr.ndim == core_ndim:
            return fn(arr, *args, **kwargs)
        flat, batch_shape = flatten_batch(arr, core_ndim)
        out = _each(lambda a: fn(a, *args, **kwargs), flat)
        return unflatten_batch(out, batch_shape)

    return wrapped


def vectorize(i: str, method: str = "scan", codim: int = None):
    """Decorator: vectorize an array function over the stacking dims of
    parameter ``i``.

    ``method`` (``scan``, ``scan_dask``, ``parallel``) and ``codim`` are
    accepted for the signature; the samples run one after the other.  The
    wrapped function maps a 1-D core input to a 1-D core output; leading
    axes are batched.
    """
    method = method.strip().lower()
    if method not in ("scan", "scan_dask", "parallel"):
        raise ValueError(f"Unknown vectorization method '{method}'.")

    def decorator(func):
        sig = inspect.signature(func)
        if i not in sig.parameters:
            raise ValueError(
                f"Parameter[{i}] not part of {func.__qualname__}() "
                f"parameter list.")

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            x = torch.as_tensor(bound.arguments.pop(i))
            rest = bound.arguments
            *sh, dim = x.shape
            out = _each(lambda xi: func(**{i: xi, **rest}),
                        x.reshape((-1, dim)))
            return out.reshape(tuple(sh) + (-1,))

        return wrapper

    return decorator
