"""Armijo backtracking line search, batched (counterpart of
``pyxu_tpu/math/linesearch.py``).

The JAX package runs the search as a ``lax.while_loop`` that shrinks the
step of every batch element still violating the Armijo condition and stops
once none does.  Here the loop runs on the host: each trial is masked on
the device and the host reads one flag a trial, whether any element is
still bad, so the trial count (and with it every step size) is the JAX
package's exactly.  ``backtracking_linesearch.trials`` counts the shrink
trials and ``runtime.host_read.count`` the reads.
"""

from __future__ import annotations

import math as _math

import torch

from pyxu_tpu_torch.runtime import host_read

__all__ = ["backtracking_linesearch"]

LINESEARCH_DEFAULT_R = 0.5
LINESEARCH_DEFAULT_C = 1e-4


def backtracking_linesearch(f, x, direction, gradient=None, a0: float = None,
                            r: float = LINESEARCH_DEFAULT_R,
                            c: float = LINESEARCH_DEFAULT_C,
                            maxiter: int = 30, core_ndim: int = None):
    r"""Step ``a`` with f(x + a d) <= f(x) + c a <grad f(x), d>, per batch
    element.

    ``f`` has ``apply``/``grad``; ``a0=None`` takes ``1/f.diff_lipschitz``,
    or 1 when that constant is unknown.  A trial whose value is NaN counts
    as failed.  At most ``maxiter`` trials.  Returns the steps, shaped like
    ``f.apply(x)``.
    """
    if a0 is None:
        try:
            dl = float(getattr(f, "diff_lipschitz", _math.inf))
        except (TypeError, ValueError):
            dl = _math.inf
        a0 = 1.0 / dl if _math.isfinite(dl) and dl > 0 else 1.0
    d = direction
    core_ndim = len(f.dim_shape) if core_ndim is None else core_ndim
    axes = tuple(range(x.ndim - core_ndim, x.ndim))
    g = f.grad(x) if gradient is None else gradient
    f0 = f.apply(x)
    slope = c * torch.sum(g * d, dim=axes)

    def bad(a, fa):
        return torch.logical_not(fa <= f0 + a * slope)   # NaN fails too

    a = torch.full_like(f0, a0)
    fa = f.apply(x + _bc(a, core_ndim) * d)
    for _ in range(int(maxiter)):
        failed = bad(a, fa)
        if not host_read(torch.any(failed)):
            break
        backtracking_linesearch.trials += 1
        a = torch.where(failed, r * a, a)
        fa = f.apply(x + _bc(a, core_ndim) * d)
    return a


backtracking_linesearch.trials = 0


def _bc(a, core_ndim: int):
    return a.reshape(a.shape + (1,) * core_ndim)
