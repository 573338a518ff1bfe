"""Conjugate-gradient linear solve (counterpart of ``pyxu_tpu/math/cg.py``).

The nested solver of ``QuadraticFunc.prox`` and of the ADMM x-update.
Where the JAX loop exits once every residual is small (``rs <= tol2``),
this loop masks the step to 0 on the device, which freezes the iterate, so
both return the same ``x``.  A budget of at most :data:`CHECK_RATE`
iterations runs whole and never reads a value back to the host, which
keeps the solver engine's contract of one host read per segment
(``abc/solver.py``; the RI path's inner CG runs 3).  A larger budget reads
the convergence flag once every :data:`CHECK_RATE` iterations and stops
there, so it runs at most ``CHECK_RATE - 1`` frozen iterations past the
JAX loop's exit.
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.runtime import host_read

__all__ = ["cg_solve", "CHECK_RATE"]

CHECK_RATE = 8      # iterations between host reads of the convergence flag


def cg_solve(matvec, b, x0=None, *, rtol: float = 1e-6, atol: float = 0.0,
             maxiter: int = None, core_ndim: int = None,
             restart_rate: int = None, precond=None):
    """Solve ``matvec(x) = b`` for symmetric positive-definite ``matvec``.

    ``b``: right-hand side ``(*batch, *core_shape)``; ``core_ndim``: rank
    of the vector part (trailing axes), ``None`` = all of ``b``.
    ``restart_rate``: recompute the true residual every so many iterations
    (never, when it is at least ``maxiter``).  ``precond``: optional SPD
    preconditioner ``z = M^{-1}(r)``; the stopping test stays on the true
    residual norm.  The iterate moves while any batch element's residual
    exceeds ``max(rtol ||b||, atol)``, as the JAX loop's does; budgets
    above :data:`CHECK_RATE` stop at the first check that finds none.
    """
    core_ndim = b.ndim if core_ndim is None else core_ndim
    axes = tuple(range(b.ndim - core_ndim, b.ndim))
    if maxiter is None:
        maxiter = 10 * max(b.numel(), 1)
    if restart_rate is None:
        restart_rate = max(maxiter, 1)

    def dot(u, v):
        return torch.sum(u * v, dim=axes) if axes else u * v

    def bcast(s):
        return s.reshape(s.shape + (1,) * core_ndim)

    if x0 is None:
        x = torch.zeros_like(b)
    else:
        x = torch.as_tensor(x0).to(device=b.device, dtype=b.dtype) \
            .broadcast_to(b.shape)
    M = precond if precond is not None else (lambda r: r)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz, rs = dot(r, z), dot(r, r)
    tol2 = torch.clamp(rtol * rtol * dot(b, b), min=atol * atol)
    eps = torch.finfo(b.dtype).tiny
    for k in range(int(maxiter)):
        # once every residual is small the step is 0: x and r stay as they
        # are, and so do rz and rs (p still moves, but is never used again)
        active = torch.any(rs > tol2)
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(active & (denom > eps),
                            rz / torch.clamp(denom, min=eps), 0.0)
        x = x + bcast(alpha) * p
        if restart_rate < maxiter and (k + 1) % restart_rate == 0:
            r = torch.where(active, b - matvec(x), r)
        else:
            r = r - bcast(alpha) * Ap
        z = M(r)
        rz_new, rs = dot(r, z), dot(r, r)
        beta = torch.where(rz > eps, rz_new / torch.clamp(rz, min=eps), 0.0)
        p = z + bcast(beta) * p
        rz = rz_new
        if (maxiter > CHECK_RATE and (k + 1) % CHECK_RATE == 0
                and not host_read(torch.any(rs > tol2))):
            break
    return x
