r"""Nonlinear conjugate gradient (counterpart of
``pyxu_tpu/opt/solver/nlcg.py``).

``min_x f(x)``, f differentiable: an Armijo backtracking line search along
the direction each step (:mod:`pyxu_tpu_torch.math.linesearch`), then the
PR+ ("PR") or Fletcher-Reeves ("FR") update of the direction.  Every
``restart_rate`` steps (default ``f.dim_size``) the direction restarts at
steepest descent; the restart is decided on the device from the int32
counter ``k``, so it costs no read.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.math.linesearch import backtracking_linesearch
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["NLCG"]


class NLCG(Solver):
    r"""min_x f(x), f differentiable."""

    def __init__(self, f, **kwargs):
        """``kwargs``: the engine's (:class:`~pyxu_tpu_torch.abc.solver.
        Solver`), ``log_var`` ``("x",)`` by default."""
        kwargs.setdefault("log_var", ("x",))
        super().__init__(**kwargs)
        self._f = f

    def m_init(self, x0, variant: str = "PR", restart_rate: int = None,
               a0: float = None, r: float = 0.5, c: float = 1e-4,
               device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  ``a0`` (the line search's first
        trial) defaults to ``1/f.diff_lipschitz``, else 1."""
        dev = resolve_device(device, like=x0)
        if not isinstance(x0, torch.Tensor):
            x0 = torch.from_numpy(np.ascontiguousarray(x0))
        x0 = x0.to(dev)
        assert variant in ("PR", "FR")
        self._variant = variant
        self._restart = int(restart_rate or self._f.dim_size)
        if a0 is None:
            beta = self._f.diff_lipschitz
            a0 = 1.0 if (not _math.isfinite(beta) or beta == 0) \
                else 1.0 / beta
        self._ls = dict(a0=float(a0), r=float(r), c=float(c))
        g = self._f.grad(x0)
        return {"x": x0, "g": g, "p": -g,
                "k": torch.zeros((), dtype=torch.int32, device=dev)}

    def _dot(self, u, v):
        axes = tuple(range(u.ndim - len(self._f.dim_shape), u.ndim))
        return torch.sum(u * v, dim=axes)

    def m_step(self, mst):
        x, g, p, k = mst["x"], mst["g"], mst["p"], mst["k"]
        rank = len(self._f.dim_shape)
        a = backtracking_linesearch(self._f, x, p, gradient=g, **self._ls)
        xp = x + a.reshape(a.shape + (1,) * rank) * p
        gp = self._f.grad(xp)
        gg = self._dot(g, g)
        eps = torch.finfo(x.dtype).tiny
        if self._variant == "FR":
            beta = self._dot(gp, gp) / torch.clamp(gg, min=eps)
        else:  # PR+
            beta = torch.clamp(self._dot(gp, gp - g)
                               / torch.clamp(gg, min=eps), min=0.0)
        beta = torch.where((k + 1) % self._restart == 0, 0.0, beta)
        pp = -gp + beta.reshape(beta.shape + (1,) * rank) * p
        return {"x": xp, "g": gp, "p": pp, "k": k + 1}

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="x", rank=len(self._f.dim_shape))

    def objective_func(self, mstate):
        return self._f.apply(mstate["x"])
