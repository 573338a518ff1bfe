"""Conjugate-gradient solver in operator form (counterpart of
``pyxu_tpu/opt/solver/cg.py``).

Solves ``A x = b`` for a positive-definite LinOp ``A``, with batched
right-hand sides (leading axes of ``b``), a refresh of the true residual
every ``restart_rate`` iterations (default ``A.dim_size``), the default
stop ``AbsError(1e-4)`` on the residual and ``sqrt(max rs)`` as the
objective.  The iterations run in the BLOCK segment engine of
:class:`pyxu_tpu_torch.abc.solver.Solver`.

The iteration count ``k`` is a host integer of the state, so whether a
step refreshes the residual is decided on the host with no read from the
device: a step computes only the branch it takes (the JAX package selects
between the two with ``lax.cond``).
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.opt.stop import AbsError
from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["CG"]


class CG(Solver):
    """Conjugate gradient for ``A x = b``, ``A`` positive definite."""

    def __init__(self, A, **kwargs):
        """``kwargs``: the engine's (:class:`~pyxu_tpu_torch.abc.solver.
        Solver`), ``log_var`` ``("x",)`` by default."""
        kwargs.setdefault("log_var", ("x",))
        super().__init__(**kwargs)
        self._A = A

    def m_init(self, b, x0=None, restart_rate: int = None, device=None):
        """``b`` ``(*batch, *A.dim_shape)``: a tensor runs on its device, a
        host array goes to ``device`` (default ``cuda``).  ``x0`` (default
        0) broadcasts against it."""
        dev = resolve_device(device, like=b)
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        b = b.to(dev)
        self._restart = int(restart_rate) if restart_rate else \
            self._A.dim_size
        if x0 is None:
            x = torch.zeros_like(b)
        else:
            x = torch.as_tensor(x0).to(device=b.device, dtype=b.dtype) \
                .broadcast_to(b.shape)
        r = b - self._A.apply(x)
        return {"x": x, "b": b, "r": r, "p": r, "rs": self._dot(r, r),
                "k": 0}

    def _dot(self, u, v):
        axes = tuple(range(u.ndim - self._A.dim_rank, u.ndim))
        return torch.sum(u * v, dim=axes)

    def _bcast(self, s):
        return s.reshape(s.shape + (1,) * self._A.dim_rank)

    def m_step(self, mstate):
        x, b, r, p, rs, k = (mstate[n] for n in ("x", "b", "r", "p", "rs",
                                                 "k"))
        eps = torch.finfo(x.dtype).tiny
        Ap = self._A.apply(p)
        denom = self._dot(p, Ap)
        alpha = torch.where(denom > eps, rs / torch.clamp(denom, min=eps),
                            0.0)
        x = x + self._bcast(alpha) * p
        if (k + 1) % self._restart == 0:
            r = b - self._A.apply(x)
        else:
            r = r - self._bcast(alpha) * Ap
        rs_new = self._dot(r, r)
        beta = torch.where(rs > eps, rs_new / torch.clamp(rs, min=eps), 0.0)
        p = r + self._bcast(beta) * p
        return {"x": x, "b": b, "r": r, "p": p, "rs": rs_new, "k": k + 1}

    def default_stop_crit(self):
        return AbsError(eps=1e-4, var="r", rank=self._A.dim_rank)

    def objective_func(self, mstate):
        """The residual norm (the largest over the batch)."""
        return torch.sqrt(torch.max(mstate["rs"]))
