r"""Primal-dual splitting (counterpart of ``pyxu_tpu/opt/solver/pds.py``).

Problem: ``min_x f(x) + g(x) + h(K x)`` with f differentiable (Lipschitz
gradient beta), g and h proximable, K linear.  Step sizes are derived on
the host at ``m_init`` from beta and ``||K||`` with the three tuning
strategies of the reference; a constant that f or K does not declare is
estimated there, on the state's dtype and device.

Spans (:func:`~pyxu_tpu_torch.utils.profiler.span`): ``solver.step_sizes``,
``solver.estimate_lipschitz`` (an estimate inside it), ``solver.fuse_match``
(``CondatVu``'s fusion match), and at the operands' boundary ``op.K.apply``,
``op.K.adjoint`` and, in ``CondatVu``'s generic iteration, ``op.f.grad``,
``op.g.prox`` and ``op.h.fenchel_prox``.

The whole family: ``CondatVu`` (with its fusion pass), ``PD3O``, ``ADMM``
(all three x-updates), ``DouglasRachford``, and the specialisations
``ChambollePock``, ``ForwardBackward`` and ``ProximalPoint`` (of
``CondatVu``), ``LorisVerhoeven`` and ``DavisYin`` (of ``PD3O``), each
under its short alias too.
"""

from __future__ import annotations

import copy
import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import Property
from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.opt.stop import RelError
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import asarray_astype
from pyxu_tpu_torch.utils.profiler import span, spanned

__all__ = [
    "CondatVu", "CV", "PD3O", "ChambollePock", "CP", "LorisVerhoeven", "LV",
    "DavisYin", "DY", "DouglasRachford", "DR", "ADMM", "ForwardBackward",
    "FB", "ProximalPoint", "PP",
]


def _initial_state(x0, device):
    """``x0`` as a tensor on its own device, or a host array on ``device``
    (default ``cuda``), and that device."""
    dev = resolve_device(device, like=x0)
    if not isinstance(x0, torch.Tensor):
        x0 = torch.from_numpy(np.ascontiguousarray(x0))
    return x0.to(dev), dev


class _PrimalDualSplitting(Solver):
    """Common problem spec and step-size machinery."""

    def __init__(self, f=None, g=None, h=None, K=None, **kwargs):
        """``kwargs``: the engine's (:class:`~pyxu_tpu_torch.abc.solver.
        Solver`), ``log_var`` ``("x", "z")`` by default."""
        kwargs.setdefault("log_var", ("x", "z"))
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
    def _beta(self, **kw) -> float:
        """f's diff-Lipschitz constant; estimated (``kw``: ``dtype``,
        ``device``) when f declares none."""
        b = self._f.diff_lipschitz
        if not _math.isfinite(b):
            with span("solver.estimate_lipschitz"):
                b = self._f.estimate_diff_lipschitz(**kw)
        return float(b)

    def _norm_K(self, **kw) -> float:
        """||K||; estimated (``kw`` as in :meth:`_beta`) when K declares
        no Lipschitz constant."""
        if self._K is None:
            return 1.0 if self._h is not None else 0.0
        L = self._K.lipschitz
        if not _math.isfinite(L):
            with span("solver.estimate_lipschitz"):
                L = self._K.estimate_lipschitz(**kw)
        return float(L)

    @spanned("solver.step_sizes")
    def _set_steps(self, tau, sigma, rho, tuning_strategy, **kw):
        """(tau, sigma, rho) with 1/tau - sigma ||K||^2 >= gamma; strategy
        1: gamma = beta, rho = 1; 2: gamma = beta/1.9; 3: rho = delta - 0.1.
        Constants the operators do not declare are estimated on ``kw``'s
        ``dtype`` and ``device``, the state's."""
        beta = self._beta(**kw) if (tau is None or sigma is None) \
            else float(self._f.diff_lipschitz)
        L = self._norm_K(**kw) if (tau is None or sigma is None) else 1.0
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
        x0, dev = _initial_state(x0, device)
        self._set_steps(tau, sigma, rho, tuning_strategy, dtype=x0.dtype,
                        device=dev)
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
        if self._K is None:
            return z
        with span("op.K.adjoint"):
            return self._K.adjoint(z)

    def _Kf(self, x):
        if self._K is None:
            return x
        with span("op.K.apply"):
            return self._K.apply(x)


class CondatVu(_PrimalDualSplitting):
    r"""Condat-Vu splitting.

    x+ = prox_{tau g}(x - tau grad f(x) - tau K^T z)
    z+ = prox_{sigma h*}(z + sigma K(2x+ - x))
    (x, z) <- (1-rho)(x, z) + rho(x+, z+)

    Fusion pass: when the problem is the TV-deconvolution family (see
    :mod:`pyxu_tpu_torch.ops.fused_tv`) and ``fuse`` is on, each iteration
    runs as one fused step and the engine's K-step hook runs K iterations
    per pass.  The choice is made at ``m_init``, and made again on the
    state of a fit that skips it (``warm_start``, each phase of a
    ``precision_schedule``: a bf16 phase takes the kernels with bf16
    storage), and recorded in ``fused_path``: ``"kernel"`` (CUDA kernels),
    ``"plain"`` (the plain PyTorch version, CPU state) or ``None`` (the
    generic operator path).
    """

    def __init__(self, f=None, g=None, h=None, K=None, fuse: bool = True,
                 **kwargs):
        super().__init__(f=f, g=g, h=h, K=K, **kwargs)
        self._fuse = bool(fuse)
        self._fused = None
        self.fused_path = None

    def _m_init_extra(self, mst):
        self._m_refresh(mst)
        return mst

    # the generic iteration's operand calls, each in its span; called
    # inside the iteration's expressions, so that no temporary outlives
    # the expression it is part of
    def _grad_f(self, x):
        with span("op.f.grad"):
            return self._f.grad(x)

    def _prox_g(self, x, tau):
        with span("op.g.prox"):
            return self._g.prox(x, tau)

    def _fenchel_prox_h(self, z, sigma):
        with span("op.h.fenchel_prox"):
            return self._h.fenchel_prox(z, sigma)

    def _m_refresh(self, mst):
        from pyxu_tpu_torch.ops.fused_tv import match_fused_tv, match_fused_tv2
        self._fused, self.fused_path = None, None
        self._m_step2, self._m_step2_iters = None, 0
        if not self._fuse:
            return
        x, z = mst["x"], mst.get("z")
        with span("solver.fuse_match"):
            fused = match_fused_tv(self._f, self._g, self._h, self._K,
                                   tau=self._tau, sigma=self._sigma,
                                   rho=self._rho, x=x, z=z)
            n = None if fused is None else match_fused_tv2(fused,
                                                           tuple(x.shape))
        if fused is None:
            return
        self._fused = fused
        self.fused_path = "kernel" if x.is_cuda else "plain"
        if n is not None:
            def step2(s, _n=n):
                xn, zn = fused.stepk(s["x"], s["z"], _n)
                return {"x": xn, "z": zn}
            self._m_step2, self._m_step2_iters = step2, n

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
        xp = self._prox_g(x - tau * self._grad_f(x) - tau * self._Kt(zc), tau)
        zp = self._fenchel_prox_h(zc + sigma * self._Kf(2 * xp - x), sigma)
        return {"x": (x + rho * (xp - x)).to(x.dtype),
                "z": (zc + rho * (zp - zc)).to(z.dtype)}


CV = CondatVu


class PD3O(_PrimalDualSplitting):
    r"""Primal-Dual Three-Operator splitting, one adjoint and one gradient
    an iteration::

        x  = prox_{tau g}(u - tau K^T z)
        u+ = (1-rho) u + rho (x - tau grad f(x))
        z+ = (1-rho) z + rho prox_{sigma h*}(z + sigma K(2x - tau grad f(x) - u))

    with the state ``u`` started at x0.
    """

    def _m_init_extra(self, mst):
        from pyxu_tpu_torch.operator.linop.base import NullFunc
        x0 = mst["x"]
        if self._h is None and isinstance(self._g, NullFunc):
            # with g = h = 0 and u0 = x0 the first step would not move and
            # the first RelError check would stop the solve at x0; the
            # additive part nudges x0 = 0 too
            mst["u"] = x0 * 1.01 + 0.01
        else:
            mst["u"] = x0
        return mst

    def m_step(self, mst):
        u = mst["u"]
        tau, sigma, rho = self._tau, self._sigma, self._rho
        if self._h is None:
            x = self._g.prox(u, tau)
            ut = x - tau * self._f.grad(x)
            return {"x": x, "u": u + rho * (ut - u)}
        z = mst["z"]
        x = self._g.prox(u - tau * self._Kt(z), tau)
        ut = x - tau * self._f.grad(x)
        zt = self._h.fenchel_prox(z + sigma * self._Kf(x + ut - u), sigma)
        return {"x": x, "u": u + rho * (ut - u), "z": z + rho * (zt - z)}


def ChambollePock(g=None, h=None, K=None, **kwargs):
    """Condat-Vu with f = 0."""
    slv = CondatVu(f=None, g=g, h=h, K=K, **kwargs)
    slv._name = "ChambollePock"
    return slv


CP = ChambollePock


def LorisVerhoeven(f=None, h=None, K=None, **kwargs):
    """PD3O with g = 0."""
    slv = PD3O(f=f, g=None, h=h, K=K, **kwargs)
    slv._name = "LorisVerhoeven"
    return slv


LV = LorisVerhoeven


def DavisYin(f=None, g=None, h=None, **kwargs):
    """PD3O with K = identity."""
    slv = PD3O(f=f, g=g, h=h, K=None, **kwargs)
    slv._name = "DavisYin"
    return slv


DY = DavisYin


class DouglasRachford(_PrimalDualSplitting):
    r"""Condat-Vu with f = 0, K = identity and sigma = 1/tau::

        x+ = prox_{tau g}(z)
        z+ = z + prox_{tau h}(2 x+ - z) - x+
    """

    def __init__(self, g=None, h=None, **kwargs):
        super().__init__(f=None, g=g, h=h, K=None, **kwargs)

    def m_init(self, x0, z0=None, tau: float = 1.0, device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  z0 defaults to x0."""
        x0, dev = _initial_state(x0, device)
        self._tau = float(tau)
        self._sigma = 1.0 / self._tau
        self._rho = 1.0
        z0 = x0 if z0 is None else asarray_astype(z0, x0.dtype, dev)
        return {"x": x0, "z": z0}

    def m_step(self, mst):
        z, tau = mst["z"], self._tau
        xp = self._g.prox(z, tau)
        zp = z + self._h.prox(2 * xp - z, tau) - xp
        return {"x": xp, "z": zp}

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="x", rank=len(self._dim_shape))


DR = DouglasRachford


def ForwardBackward(f=None, g=None, **kwargs):
    """Condat-Vu with h = 0."""
    slv = CondatVu(f=f, g=g, h=None, K=None, **kwargs)
    slv._name = "ForwardBackward"
    return slv


FB = ForwardBackward


def ProximalPoint(g=None, **kwargs):
    """Condat-Vu with f = h = 0."""
    slv = CondatVu(f=None, g=g, h=None, K=None, **kwargs)
    slv._name = "ProximalPoint"
    return slv


PP = ProximalPoint


class ADMM(_PrimalDualSplitting):
    r"""ADMM for ``min_x f(x) + h(K x)``.

    K = None (classical prox-ADMM)::

        x+ = prox_{tau f}(z - u)
        z+ = prox_{tau h}(x+ + u)
        u+ = u + x+ - z+

    With K, the x-update is ``argmin_x f(x) + ||K x - (z - u)||^2 / (2 tau)``,
    solved by a nested fixed-iteration CG when f is quadratic, else by a
    fixed number of gradient steps whose step is set once, in ``m_init``.
    ``solver_kwargs`` (``maxiter``, ``rtol``) tune the nested solve; with
    K = None and a quadratic f they go to ``f.prox``'s CG on a private
    shallow copy of f, so the caller's operator keeps its own settings.
    """

    def __init__(self, f=None, h=None, K=None, solver_kwargs=None, **kwargs):
        if f is None:
            from pyxu_tpu_torch.operator.linop.base import NullFunc
            f = NullFunc(K.dim_shape if K is not None else h.dim_shape)
        kwargs.setdefault("log_var", ("x", "z", "u"))
        super().__init__(f=f, h=h, K=K, **kwargs)
        self._dim_shape = f.dim_shape
        self._solver_kwargs = dict(solver_kwargs or {})
        if K is not None:
            if not (f.has(Property.QUADRATIC)
                    or f.has(Property.DIFFERENTIABLE)):
                raise ValueError("with K, the x-update needs f quadratic "
                                 "(CG) or differentiable (gradient steps)")
        elif self._solver_kwargs and f.has(Property.QUADRATIC):
            self._f = f = copy.copy(f)
            if "maxiter" in self._solver_kwargs:
                f._prox_maxiter = int(self._solver_kwargs["maxiter"])
            if "rtol" in self._solver_kwargs:
                f._prox_rtol = float(self._solver_kwargs["rtol"])

    def m_init(self, x0, z0=None, u0=None, tau: float = None, device=None):
        """``x0`` as a tensor runs on its device; a host array goes to
        ``device`` (default ``cuda``).  ``tau`` defaults to 1."""
        x0, dev = _initial_state(x0, device)
        self._tau = 1.0 if tau is None else float(tau)
        needs_gd = (not self._f.has(Property.QUADRATIC)
                    and not (self._K is None
                             and self._f.has(Property.PROXIMABLE)))
        if needs_gd and self._f.has(Property.DIFFERENTIABLE):
            kw = dict(dtype=x0.dtype, device=dev)
            beta = self._f.diff_lipschitz
            if not _math.isfinite(beta):
                beta = self._f.estimate_diff_lipschitz(**kw)
            LK = 1.0
            if self._K is not None:
                LK = self._K.lipschitz
                if not _math.isfinite(LK):
                    LK = self._K.estimate_lipschitz(**kw)
            self._gd_step = 1.0 / (max(float(beta), 1e-12)
                                   + float(LK) ** 2 / self._tau)
        Kx = self._Kf(x0)
        z0 = Kx if z0 is None else asarray_astype(z0, x0.dtype, dev)
        u0 = torch.zeros_like(z0) if u0 is None \
            else asarray_astype(u0, x0.dtype, dev)
        return {"x": x0, "z": z0, "u": u0}

    def _x_update(self, x, v):
        """argmin_x f(x) + ||K x - v||^2 / (2 tau)."""
        tau = self._tau
        if self._K is None and self._f.has(Property.PROXIMABLE):
            # cold start at v = z - u, as the JAX package does (measured
            # there: more accurate than warm-starting at the previous x)
            return self._f.prox(v, tau)
        if self._f.has(Property.QUADRATIC):
            from pyxu_tpu_torch.math.cg import cg_solve
            Q, c, _ = self._f._quad_spec()
            # (Q + K^T K / tau) x = K^T v / tau - c
            b = self._Kt(v) / tau - c.grad(torch.zeros_like(x))
            return cg_solve(
                lambda p: Q.apply(p) + self._Kt(self._Kf(p)) / tau, b, x0=x,
                rtol=self._solver_kwargs.get("rtol", 1e-6),
                maxiter=self._solver_kwargs.get("maxiter", 50),
                core_ndim=len(self._dim_shape))
        step = self._gd_step
        for _ in range(self._solver_kwargs.get("maxiter", 20)):
            x = x - step * (self._f.grad(x)
                            + self._Kt(self._Kf(x) - v) / tau)
        return x

    def m_step(self, mst):
        x, z, u = mst["x"], mst["z"], mst["u"]
        xp = self._x_update(x, z - u)
        Kx = self._Kf(xp)
        zp = self._h.prox(Kx + u, self._tau)
        return {"x": xp, "z": zp, "u": u + Kx - zp}

    def default_stop_crit(self):
        return RelError(eps=1e-4, var="x", rank=len(self._dim_shape))

    def objective_func(self, mstate):
        x = mstate["x"]
        return self._f.apply(x) + self._h.apply(self._Kf(x))
