r"""Proximal Gradient Descent / FISTA (counterpart of
``pyxu_tpu/opt/solver/pgd.py``).

Problem: ``min_x f(x) + g(x)`` with f differentiable, g proximable.
Chambolle-Dossal acceleration ``a_k = k / (k + 1 + d)`` (d = 75), step
``tau = 1 / f.diff_lipschitz`` (the closed form when f has one, else its
estimate), default stop ``RelError(1e-4, "x")``.  The iterations run in the
BLOCK segment engine of :class:`pyxu_tpu_torch.abc.solver.Solver`.

Per iteration the gradient of the LASSO data term is ``K^T K y + c``, with
``c`` from the constant-gradient cache: one Stencil apply and one adjoint.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["PGD"]


class PGD(Solver):
    r"""min_x f(x) + g(x), f differentiable, g proximable."""

    def __init__(self, f=None, g=None, **kwargs):
        super().__init__(**kwargs)
        if f is None and g is None:
            raise ValueError("at least one of f, g must be given")
        dim_shape = (f or g).dim_shape
        from pyxu_tpu_torch.operator.linop.base import NullFunc
        self._f = f if f is not None else NullFunc(dim_shape)
        self._g = g
        self._dim_shape = dim_shape

    def m_init(self, x0, tau: float = None, acceleration: bool = True,
               d: float = 75.0, device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  Without ``tau``, an f whose
        diff-Lipschitz constant is unknown has it estimated once, on the
        state's device and dtype."""
        dev = resolve_device(device, like=x0)
        if not isinstance(x0, torch.Tensor):
            x0 = torch.from_numpy(np.ascontiguousarray(x0))
        x0 = x0.to(dev)
        if tau is None:
            beta = self._f.diff_lipschitz
            if not _math.isfinite(beta) or beta == 0:
                beta = self._f.estimate_diff_lipschitz(dtype=x0.dtype,
                                                       device=dev)
            if not (_math.isfinite(beta) and beta > 0):
                raise ValueError("tau not given and f.diff_lipschitz "
                                 f"unusable ({beta})")
            tau = 1.0 / beta
        self._tau = float(tau)
        self._accel = bool(acceleration)
        self._d = float(d)
        # counter in f32 whatever the iterate dtype (bf16 would freeze at
        # k = 256 and stall the momentum schedule)
        return {"x": x0, "x_prev": x0,
                "k": torch.zeros((), dtype=torch.float32, device=dev)}

    def m_step(self, mstate):
        x, x_prev, k = mstate["x"], mstate["x_prev"], mstate["k"]
        if self._accel:
            a = (k / (k + 1.0 + self._d)).to(x.dtype)
            y = x + a * (x - x_prev)
        else:
            y = x
        z = y - self._tau * self._f.grad(y)
        x_new = self._g.prox(z, self._tau) if self._g is not None else z
        return {"x": x_new, "x_prev": x, "k": k + 1.0}

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="x")

    def objective_func(self, mstate):
        x = mstate["x"]
        val = self._f.apply(x)
        if self._g is not None:
            val = val + self._g.apply(x)
        return val
