"""The kernel wrappers' refusal of autodiff.

A wrapper hands raw device pointers to a hand-written kernel and defines
no autograd rule, so a ``torch.func`` transform (``jvp``, ``vjp``,
``grad``) or a recording autograd graph that reached one would lose the
derivative.  The wrappers call :func:`refuse_autodiff` before a launch and
raise instead; their plain versions (CPU tensors) differentiate as any
PyTorch code does.
"""

from __future__ import annotations

import torch

__all__ = ["refuse_autodiff"]


def refuse_autodiff(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` if a tensor is under a ``torch.func`` transform
    or requires grad while grad mode is on."""
    for t in tensors:
        if torch._C._functorch.is_functorch_wrapped_tensor(t) or (
                t.requires_grad and torch.is_grad_enabled()):
            raise ValueError(
                f"{name}: the CUDA kernel has no autograd rule, so it cannot "
                "run under torch.func transforms or a recording autograd "
                "graph; linearise the operator around it (its jacobian is "
                "itself) or use CPU tensors")
