"""Precision policy re-exports and device resolution.

``resolve_device`` is the one place that decides where an entry point runs:
an explicit device wins, then the device of a tensor argument, else
``cuda``.  With no GPU present and no device given it raises — the port
never carries on on the CPU unasked.

``host_read`` is the one place where the solver engine, the line search and
the nested CG read a flag back from the device; ``host_read.count`` counts
those reads.
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.info.dtypes import (  # noqa: F401
    Precision,
    Width,
    atol_for,
    default_fdtype,
    getPrecision,
    set_default_width,
)

__all__ = [
    "Width",
    "Precision",
    "default_fdtype",
    "set_default_width",
    "getPrecision",
    "atol_for",
    "resolve_device",
    "host_read",
]


def resolve_device(device=None, like=None) -> torch.device:
    """Device an entry point runs on.

    ``device`` (explicit) wins; else the device of the tensor ``like``;
    else ``cuda``, which must exist.
    """
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or CPU tensors) to run on "
            "the CPU")
    return torch.device("cuda")


def host_read(flag) -> bool:
    """``bool(flag)``.  A tensor is read back from its device (a wait for the
    work queued before it) and counted in ``host_read.count``; a Python bool
    is returned as it is, with no read."""
    if isinstance(flag, torch.Tensor):
        host_read.count += 1
    return bool(flag)


host_read.count = 0
