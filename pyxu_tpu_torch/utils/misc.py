"""Shape canonicalisation and array conversion (counterpart of
``pyxu_tpu/utils/misc.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["as_canonical_shape", "asarray_astype", "next_fast_len", "peaks"]


def as_canonical_shape(shape) -> tuple:
    """Normalise a shape spec (int, iterable of ints, ``None``/``()``) to a
    tuple of ints."""
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def asarray_astype(arr, dtype, device=None) -> torch.Tensor:
    """``arr`` as a tensor of ``dtype``.  Host inputs are cast on the host
    before the copy to ``device`` (one transfer of the final bytes); tensors
    keep their device unless ``device`` is given."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device if device is not None else arr.device,
                      dtype=dtype)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return host.to(dtype=dtype).to(device if device is not None else "cpu")


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth number >= n (the JAX package's rule, so that fine
    grids and circulant sizes match it)."""
    if n <= 1:
        return 1
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
                    if best is None or p < best:
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
