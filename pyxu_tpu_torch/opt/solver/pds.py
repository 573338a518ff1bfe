r"""Primal-dual splitting (counterpart of ``pyxu_tpu/opt/solver/pds.py``).

Problem: ``min_x f(x) + g(x) + h(K x)`` with f differentiable (Lipschitz
gradient beta), g and h proximable, K linear.  Step sizes are derived on
the host at ``m_init`` from beta and ``||K||`` with the three tuning
strategies of the reference.

Ported: ``_PrimalDualSplitting`` and ``CondatVu`` (with its fusion pass).
The other eleven solvers of the family are not ported yet.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import Property
from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import asarray_astype

__all__ = ["CondatVu", "CV"]


class _PrimalDualSplitting(Solver):
    """Common problem spec and step-size machinery."""

    def __init__(self, f=None, g=None, h=None, K=None, **kwargs):
        super().__init__(**kwargs)
        ref = f or g or (h if K is None else None)
        if ref is None and K is not None:
            dim_shape = K.dim_shape
        else:
            if ref is None:
                raise ValueError("at least one of f, g, h must be specified")
            dim_shape = ref.dim_shape
        from pyxu_tpu_torch.operator.linop.base import NullFunc
        self._f = f if f is not None else NullFunc(dim_shape)
        self._g = g if g is not None else NullFunc(dim_shape)
        self._h = h
        self._K = K
        self._dim_shape = dim_shape

    # -- step sizes --------------------------------------------------------
    def _beta(self) -> float:
        b = self._f.diff_lipschitz
        if not _math.isfinite(b):
            raise NotImplementedError(
                "f has no closed-form diff-Lipschitz constant; its estimator "
                "is not ported yet — pass tau/sigma explicitly")
        return float(b)

    def _norm_K(self) -> float:
        if self._K is None:
            return 1.0 if self._h is not None else 0.0
        L = self._K.lipschitz
        if not _math.isfinite(L):
            raise NotImplementedError(
                "K has no closed-form Lipschitz constant; its estimator is "
                "not ported yet — pass tau/sigma explicitly")
        return float(L)

    def _set_steps(self, tau, sigma, rho, tuning_strategy):
        """(tau, sigma, rho) with 1/tau - sigma ||K||^2 >= gamma; strategy
        1: gamma = beta, rho = 1; 2: gamma = beta/1.9; 3: rho = delta - 0.1."""
        beta = self._beta() if (tau is None or sigma is None) \
            else float(self._f.diff_lipschitz)
        L = self._norm_K() if (tau is None or sigma is None) else 1.0
        gamma = beta / 1.9 if tuning_strategy == 2 else beta
        if tau is not None and sigma is None:
            if tau <= 0:
                raise ValueError(f"tau must be positive, got {tau}")
            if self._h is None:
                sigma = 0.0
            else:
                sigma = (1.0 / tau - gamma) / L ** 2
                if sigma <= 0:
                    raise ValueError(
                        "given tau violates the convergence condition")
        elif tau is None and sigma is not None:
            if sigma <= 0:
                raise ValueError(f"sigma must be positive, got {sigma}")
            tau = 1.0 / gamma if self._h is None \
                else 1.0 / (gamma + sigma * L ** 2)
        elif tau is None and sigma is None:
            if beta > 0:
                if self._h is None:
                    tau, sigma = 1.0 / gamma, 0.0
                else:
                    tau = sigma = (1.0 / L ** 2) * (
                        -gamma / 2 + _math.sqrt(gamma ** 2 / 4 + L ** 2))
            else:
                tau, sigma = (1.0, 0.0) if self._h is None \
                    else (1.0 / L, 1.0 / L)
        self._tau = float(tau)
        self._sigma = float(sigma or 0.0)
        quad = self._f.has(Property.QUADRATIC)
        if not _math.isfinite(beta) or beta == 0 or (quad and gamma <= beta):
            delta = 2.0
        else:
            delta = 2.0 - beta / (2.0 * gamma)
        if rho is None:
            rho = max(delta - 0.1, 1.0) if tuning_strategy == 3 else 1.0
        if rho > delta + 1e-9:
            raise ValueError(f"rho={rho} exceeds delta={delta}")
        self._rho = float(rho)

    def m_init(self, x0, z0=None, tau=None, sigma=None, rho=None,
               tuning_strategy: int = 1, dual_dtype=None, device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  ``dual_dtype`` (e.g.
        ``torch.bfloat16``) stores the dual state narrower than the
        primal; arithmetic stays at the primal precision."""
        dev = resolve_device(device, like=x0)
        if not isinstance(x0, torch.Tensor):
            x0 = torch.from_numpy(np.ascontiguousarray(x0))
        x0 = x0.to(dev)
        self._set_steps(tau, sigma, rho, tuning_strategy)
        mst = {"x": x0}
        if self._h is not None:
            zdt = x0.dtype if dual_dtype is None else dual_dtype
            if z0 is None:
                zshape = (x0.shape[: x0.ndim - len(self._dim_shape)]
                          + tuple(self._K.codim_shape if self._K is not None
                                  else self._dim_shape))
                z0 = torch.zeros(zshape, dtype=zdt, device=dev)
            mst["z"] = asarray_astype(z0, zdt, dev)
        return self._m_init_extra(mst)

    def _m_init_extra(self, mst):
        return mst

    def default_stop_crit(self):
        crit = RelError(eps=1e-4, var="x", rank=len(self._dim_shape))
        if self._h is not None:
            crit = crit & RelError(
                eps=1e-4, var="z",
                rank=len(self._K.codim_shape if self._K is not None
                         else self._dim_shape))
        return crit

    def objective_func(self, mstate):
        x = mstate["x"]
        val = self._f.apply(x) + self._g.apply(x)
        if self._h is not None:
            val = val + self._h.apply(self._Kf(x))
        return val

    def _Kt(self, z):
        return self._K.adjoint(z) if self._K is not None else z

    def _Kf(self, x):
        return self._K.apply(x) if self._K is not None else x


class CondatVu(_PrimalDualSplitting):
    r"""Condat-Vu splitting.

    x+ = prox_{tau g}(x - tau grad f(x) - tau K^T z)
    z+ = prox_{sigma h*}(z + sigma K(2x+ - x))
    (x, z) <- (1-rho)(x, z) + rho(x+, z+)

    Fusion pass: when the problem is the TV-deconvolution family (see
    :mod:`pyxu_tpu_torch.ops.fused_tv`) and ``fuse`` is on, each iteration
    runs as one fused step and the engine's K-step hook runs K iterations
    per pass.  The choice is made once, at ``m_init``, and recorded in
    ``fused_path``: ``"kernel"`` (CUDA kernels), ``"plain"`` (the plain
    PyTorch version, CPU state) or ``None`` (the generic operator path).
    """

    def __init__(self, f=None, g=None, h=None, K=None, fuse: bool = True,
                 **kwargs):
        super().__init__(f=f, g=g, h=h, K=K, **kwargs)
        self._fuse = bool(fuse)
        self._fused = None
        self.fused_path = None

    def _m_init_extra(self, mst):
        from pyxu_tpu_torch.ops.fused_tv import match_fused_tv, match_fused_tv2
        self._fused, self.fused_path = None, None
        self._m_step2, self._m_step2_iters = None, 0
        if not self._fuse:
            return mst
        x, z = mst["x"], mst.get("z")
        fused = match_fused_tv(self._f, self._g, self._h, self._K,
                               tau=self._tau, sigma=self._sigma,
                               rho=self._rho, x=x, z=z)
        if fused is None:
            return mst
        self._fused = fused
        self.fused_path = "kernel" if x.is_cuda else "plain"
        n = match_fused_tv2(fused, tuple(x.shape))
        if n is not None:
            def step2(s, _n=n):
                xn, zn = fused.stepk(s["x"], s["z"], _n)
                return {"x": xn, "z": zn}
            self._m_step2, self._m_step2_iters = step2, n
        return mst

    def m_step(self, mst):
        x = mst["x"]
        tau, sigma, rho = self._tau, self._sigma, self._rho
        if self._h is None:
            xp = self._g.prox(x - tau * self._f.grad(x), tau)
            return {"x": x + rho * (xp - x)}
        z = mst["z"]
        if self._fused is not None:
            xn, zn = self._fused.step(x, z)
            return {"x": xn, "z": zn}
        # generic path: compute at the primal precision, store each variable
        # back at its own dtype
        zc = z.to(x.dtype)
        xp = self._g.prox(x - tau * self._f.grad(x) - tau * self._Kt(zc), tau)
        zp = self._h.fenchel_prox(zc + sigma * self._Kf(2 * xp - x), sigma)
        return {"x": (x + rho * (xp - x)).to(x.dtype),
                "z": (zc + rho * (zp - zc)).to(z.dtype)}


CV = CondatVu
