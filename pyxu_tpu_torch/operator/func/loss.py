"""Loss construction (counterpart of ``pyxu_tpu/operator/func/loss.py``)."""

from __future__ import annotations

import torch

from pyxu_tpu_torch.abc.operator import Func

__all__ = ["shift_loss"]


def shift_loss(op: Func, data=None) -> Func:
    """f(x) -> f(x - data): a functional turned into a loss centred on
    ``data`` (a tensor stays on its device)."""
    if data is None:
        return op
    return op.argshift(-torch.as_tensor(data))
