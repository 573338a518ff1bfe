"""Autodiff at the kernel wrappers.

A wrapper hands raw device pointers to a hand-written kernel, which
autograd cannot see through.  The linear kernels (the stencil's and the
NUFFT's spread and interp) carry ``torch.autograd.Function`` rules whose
backward is the adjoint kernel; a wrapper enters its rule only when
:func:`under_autodiff` holds, and otherwise launches directly.

The fused TV step (``tv_step``/``tv_stepk``) is a nonlinear solver step
that only ``CondatVu.m_step`` calls; the JAX package does not
differentiate its Pallas step either.  Its wrapper calls
:func:`refuse_autodiff` before a launch and raises instead of losing the
derivative; its plain version (CPU tensors) differentiates as any PyTorch
code does.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad

__all__ = ["under_autodiff", "refuse_autodiff"]


_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


def under_autodiff(*tensors: torch.Tensor) -> bool:
    """Whether a tensor is under a ``torch.func`` transform, requires grad
    while grad mode is on, or carries a ``torch.autograd.forward_ad``
    tangent (looked up only inside a ``dual_level``).  A wrapper asks this
    on every call, so the common answer, no, costs a few attribute reads."""
    for t in tensors:
        if (_wrapped(t) or (t.requires_grad and torch.is_grad_enabled())
                or (forward_ad._current_level >= 0
                    and forward_ad.unpack_dual(t).tangent is not None)):
            return True
    return False


def refuse_autodiff(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` if :func:`under_autodiff` holds."""
    if under_autodiff(*tensors):
        raise ValueError(
            f"{name}: the CUDA kernel has no autograd rule, so it cannot "
            "run under torch.func transforms or a recording autograd "
            "graph; linearise the operator around it or use CPU tensors")
