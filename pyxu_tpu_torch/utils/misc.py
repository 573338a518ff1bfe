"""Shape canonicalisation and array conversion (counterpart of
``pyxu_tpu/utils/misc.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "as_canonical_shape",
    "asarray_astype",
    "broadcast_shapes_leading",
    "infer_composition_shape",
    "infer_sum_shape",
    "next_fast_len",
    "peaks",
    "star_like_sample",
]


def as_canonical_shape(shape) -> tuple:
    """Normalise a shape spec (int, iterable of ints, ``None``/``()``) to a
    tuple of ints."""
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def broadcast_shapes_leading(arr_shape: tuple, core_shape: tuple) -> tuple:
    """Split ``arr_shape`` into ``(batch, core)`` given the trailing core
    shape; raises if ``arr_shape`` does not end with ``core_shape``."""
    arr_shape, core_shape = tuple(arr_shape), tuple(core_shape)
    nc = len(core_shape)
    if nc == 0:
        return arr_shape, ()
    batch, core = arr_shape[: len(arr_shape) - nc], \
        arr_shape[len(arr_shape) - nc:]
    if core != core_shape:
        raise ValueError(f"array shape {arr_shape} does not end with core "
                         f"shape {core_shape}")
    return batch, core


def infer_sum_shape(sh1, sh2) -> tuple:
    """``(codim, dim)`` of ``op1 + op2`` from their ``(codim_shape,
    dim_shape)`` pairs: equal domains, broadcast codomains."""
    (co1, di1), (co2, di2) = sh1, sh2
    co1, di1 = as_canonical_shape(co1), as_canonical_shape(di1)
    co2, di2 = as_canonical_shape(co2), as_canonical_shape(di2)
    if di1 != di2:
        raise ValueError(f"addition of {sh1} and {sh2} operators forbidden")
    try:
        co = tuple(np.broadcast_shapes(co1, co2))
    except ValueError:
        raise ValueError(
            f"addition of {sh1} and {sh2} operators forbidden") from None
    return (co, di1)


def infer_composition_shape(sh1, sh2) -> tuple:
    """``(codim, dim)`` of ``op1 * op2`` from their ``(codim_shape,
    dim_shape)`` pairs."""
    (co1, di1), (co2, di2) = sh1, sh2
    if as_canonical_shape(di1) != as_canonical_shape(co2):
        raise ValueError(
            f"composition of {sh1} and {sh2} operators forbidden")
    return (as_canonical_shape(co1), as_canonical_shape(di2))


def asarray_astype(arr, dtype, device=None) -> torch.Tensor:
    """``arr`` as a tensor of ``dtype``.  Host inputs are cast on the host
    before the copy to ``device`` (one transfer of the final bytes); tensors
    keep their device unless ``device`` is given."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device if device is not None else arr.device,
                      dtype=dtype)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return host.to(dtype=dtype).to(device if device is not None else "cpu")


def next_fast_len(n: int, even: bool = False) -> int:
    """Smallest 5-smooth number >= n (the JAX package's rule, so that fine
    grids and circulant sizes match it); ``even``: the smallest even one
    that the search meets."""
    if n <= 1:
        return 2 if even else 1
    best = None
    a_max = int(math.ceil(math.log2(n))) + 1
    for a in range(a_max + 1):
        pa = 2 ** a
        if pa >= 8 * n:
            break
        b = 0
        while True:
            pb = pa * 3 ** b
            if pb >= 8 * n:
                break
            c = 0
            while True:
                p = pb * 5 ** c
                if p >= n:
                    if (not even or p % 2 == 0) and (best is None
                                                     or p < best):
                        best = p
                    break
                c += 1
            b += 1
    return best


def peaks(x, y):
    """MATLAB's ``peaks`` surface, in the dtype and on the device of the
    tensors ``x`` and ``y``::

        f(x, y) = 3 (1 - x)^2 exp(-x^2 - (y + 1)^2)
                  - 10 (x/5 - x^3 - y^5) exp(-x^2 - y^2)
                  - exp(-(x + 1)^2 - y^2) / 3
    """
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    a = 3 * (1 - x) ** 2 * torch.exp(-(x ** 2) - (y + 1) ** 2)
    b = -10 * (x / 5 - x ** 3 - y ** 5) * torch.exp(-(x ** 2) - (y ** 2))
    c = -torch.exp(-((x + 1) ** 2) - (y ** 2)) / 3
    return a + b + c


def star_like_sample(N: int, w: int, s: float, po: int, x0: float,
                     ndim: int = 2, dtype=None, device=None) -> torch.Tensor:
    """Star-shaped test image on an N x N grid over [-1, 1]^2: the angular
    pattern ``((1 + cos(w theta)) / 2)^po`` under the radial sigmoid
    ``1 / (1 + exp(s (r - x0)))``.  ``dtype`` defaults to the current
    width; ``device`` is resolved as every entry point resolves it."""
    from pyxu_tpu_torch.info.dtypes import default_fdtype
    from pyxu_tpu_torch.runtime import resolve_device
    if ndim != 2:
        raise ValueError("only the 2-D phantom is provided")
    grid = torch.linspace(-1.0, 1.0, N, dtype=dtype or default_fdtype(),
                          device=resolve_device(device))
    xx, yy = torch.meshgrid(grid, grid, indexing="ij")
    theta = torch.atan2(yy, xx)
    r = torch.sqrt(xx ** 2 + yy ** 2)
    env = 1.0 / (1.0 + torch.exp(s * (r - x0)))
    return env * (1 + torch.cos(w * theta)) ** po / 2 ** po
