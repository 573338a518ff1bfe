"""Shape canonicalisation and array conversion (counterpart of
``pyxu_tpu/utils/misc.py``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_canonical_shape", "asarray_astype"]


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
