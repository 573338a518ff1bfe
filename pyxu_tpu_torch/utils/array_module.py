"""Array helpers over torch tensors and numpy arrays (counterpart of
``pyxu_tpu/utils/array_module.py``).

The port computes on ``torch.Tensor``s (CPU or CUDA) and stages on the
host in numpy; these helpers give the reference vocabulary its meaning
for those two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "get_array_module",
    "compute",
    "to_numpy",
    "copy_if_unsafe",
    "read_only",
    "redirect",
]


def get_array_module(arr=None):
    """``numpy`` for a numpy array, else ``torch`` (the compute module)."""
    return np if isinstance(arr, np.ndarray) else torch


def compute(*arrs, mode: str = "compute"):
    """Materialise pending computation: synchronize the CUDA devices of the
    given tensors (kernels run asynchronously there) and return them."""
    for a in arrs:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
    return arrs[0] if len(arrs) == 1 else arrs


def to_numpy(arr) -> np.ndarray:
    """Host numpy copy (a device-to-host copy for a CUDA tensor)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def copy_if_unsafe(arr):
    """A copy where writing into ``arr`` would touch another array's
    memory or fail: a view of another tensor, or a numpy array that does
    not own its data or is read-only; else ``arr`` itself."""
    if isinstance(arr, torch.Tensor):
        return arr.clone() if arr._base is not None else arr
    if isinstance(arr, np.ndarray):
        unsafe = arr.base is not None or not arr.flags.writeable
        return arr.copy() if unsafe else arr
    return arr


def read_only(arr):
    """A read-only view of a numpy array.  Torch tensors have no
    read-only flag: a tensor is returned as it is."""
    if isinstance(arr, np.ndarray):
        out = arr.view()
        out.flags.writeable = False
        return out
    return arr


def redirect(**target_fns):
    """Decorator: dispatch to an alternative implementation by array type:
    host numpy arrays take ``NUMPY=``'s implementation, anything else the
    decorated function.

    >>> @redirect(NUMPY=my_host_impl)
    ... def f(arr): ...
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(arr, *a, **kw):
            if isinstance(arr, np.ndarray) and "NUMPY" in target_fns:
                return target_fns["NUMPY"](arr, *a, **kw)
            return fn(arr, *a, **kw)
        return wrapped

    return deco
