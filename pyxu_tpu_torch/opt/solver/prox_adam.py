r"""Proximal Adam, AMSGrad and PAdam (counterpart of
``pyxu_tpu/opt/solver/prox_adam.py``).

``min_x f(x) + g(x)``, f differentiable, g proximable (optional).  Each step
updates the moments, takes the scaled gradient step, and with g solves the
weighted-metric prox ``argmin_z g(z) + ||z - y||^2_psi / (2a)`` by a nested
PGD of ``inner_iter`` steps.  The step counter ``t`` is float32 whatever the
iterate's dtype (bf16 would freeze it at 256 and wreck the bias
correction).
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["ProxAdam"]


class ProxAdam(Solver):
    r"""min_x f(x) + g(x), f differentiable, g proximable."""

    def __init__(self, f, g=None, **kwargs):
        """``kwargs``: the engine's (:class:`~pyxu_tpu_torch.abc.solver.
        Solver`), ``log_var`` ``("x",)`` by default."""
        kwargs.setdefault("log_var", ("x",))
        super().__init__(**kwargs)
        self._f = f
        self._g = g

    def m_init(self, x0, variant: str = "adam", a: float = None,
               b1: float = 0.9, b2: float = 0.999, p: float = 0.5,
               eps_var: float = 1e-6, inner_iter: int = 10, device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  ``a`` defaults to
        ``1/f.diff_lipschitz``, else 1e-3; padam's ``p`` = 0.5 is
        AMSGrad."""
        dev = resolve_device(device, like=x0)
        if not isinstance(x0, torch.Tensor):
            x0 = torch.from_numpy(np.ascontiguousarray(x0))
        x0 = x0.to(dev)
        assert variant in ("adam", "amsgrad", "padam")
        self._variant = variant
        if a is None:
            beta = self._f.diff_lipschitz
            a = 1.0 / beta if (_math.isfinite(beta) and beta > 0) else 1e-3
        self._a = float(a)
        self._b1, self._b2 = float(b1), float(b2)
        self._p = float(p)
        self._eps = float(eps_var)
        self._inner = int(inner_iter)
        z = torch.zeros_like(x0)
        return {"x": x0, "m": z, "v": z, "v_hat": z,
                "t": torch.zeros((), dtype=torch.float32, device=dev)}

    def _phi_psi(self, mst, g):
        b1, b2 = self._b1, self._b2
        t = mst["t"] + 1.0
        m = b1 * mst["m"] + (1 - b1) * g
        v = b2 * mst["v"] + (1 - b2) * g * g
        if self._variant == "adam":
            mh = m / (1 - b1 ** t).to(m.dtype)
            vh = v / (1 - b2 ** t).to(v.dtype)
            phi, psi = mh, torch.sqrt(vh) + self._eps
            v_hat = mst["v_hat"]
        elif self._variant == "amsgrad":
            v_hat = torch.maximum(mst["v_hat"], v)
            phi, psi = m, torch.sqrt(v_hat) + self._eps
        else:  # padam: denominator v_hat**p (p = 0.5 is AMSGrad)
            v_hat = torch.maximum(mst["v_hat"], v)
            phi, psi = m, v_hat ** self._p + self._eps
        return phi, psi, m, v, v_hat, t

    def m_step(self, mst):
        x = mst["x"]
        grad = self._f.grad(x)
        phi, psi, m, v, v_hat, t = self._phi_psi(mst, grad)
        a = self._a
        y = x - a * phi / psi
        if self._g is None:
            xp = y
        else:
            # nested PGD on argmin_z g(z) + ||z - y||^2_psi / (2a)
            axes = tuple(range(-len(self._f.dim_shape), 0))
            tau = 1.0 / (torch.amax(psi, dim=axes, keepdim=True) / a)
            z = y
            for _ in range(self._inner):
                gq = psi * (z - y) / a
                z = self._g.prox(z - tau * gq, tau)
            xp = z
        return {"x": xp, "m": m, "v": v, "v_hat": v_hat, "t": t}

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="x", rank=len(self._f.dim_shape))

    def objective_func(self, mstate):
        x = mstate["x"]
        val = self._f.apply(x)
        if self._g is not None:
            val = val + self._g.apply(x)
        return val
