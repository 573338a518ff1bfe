"""Carry a deconvolution problem across from its numpy data.

:func:`tv_problem` builds the port's ``(f, h, K)`` and a :class:`CondatVu`,
:func:`lasso_problem` its ``(f, g)`` and a :class:`PGD`, from the arrays
that define the problem, so that the JAX package and this port can solve
the same problem side by side.  Step sizes not given come
from the closed-form Lipschitz constants (Stencil ``L_pad * prod ||k||_1``,
the gradient's root-sum-square, the Gram's ``L**2``), exactly as the JAX
package derives them.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["lasso_problem", "tv_problem"]


def _data(y, dtype, device):
    dev = resolve_device(device)
    y = np.asarray(y)
    dt = dtype or torch.from_numpy(np.zeros(0, y.dtype)).dtype
    return dev, dt, torch.from_numpy(np.array(y)).to(device=dev, dtype=dt)


def lasso_problem(y, taps, centers, mode="symmetric", lam=0.05, *, x0=None,
                  tau=None, dtype=None, device=None, **solver_kwargs):
    """The problem ``min_x 0.5||K x - y||^2 + lam ||x||_1`` solved by PGD.

    ``y``: (H, W) numpy data; ``taps``: the two 1-D blur kernels (rows,
    cols); ``centers``: their centres; ``mode``: the blur's boundary mode.
    ``dtype`` defaults to ``y``'s.  Returns ``(f, g, K, solver,
    fit_kwargs)`` where ``fit_kwargs`` holds ``x0`` (default 0) and ``tau``
    if given.
    """
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.operator.linop import Stencil
    from pyxu_tpu_torch.opt.solver import PGD

    dev, dt, yt = _data(y, dtype, device)
    shape = tuple(yt.shape)
    K = Stencil(shape, [np.asarray(t) for t in taps],
                [int(c) for c in centers], mode=mode)
    f = 0.5 * SquaredL2Norm(shape).asloss(yt) * K
    g = lam * L1Norm(shape)
    slv = PGD(f=f, g=g, **solver_kwargs)
    fit = {"x0": torch.zeros(shape, dtype=dt, device=dev) if x0 is None
           else torch.from_numpy(np.array(x0)).to(device=dev, dtype=dt)}
    if tau is not None:
        fit["tau"] = float(tau)
    return f, g, K, slv, fit


def tv_problem(y, taps, centers, mode="symmetric", lam=0.01, *, x0=None,
               z0=None, tau=None, sigma=None, rho=None, dtype=None,
               device=None, **solver_kwargs):
    """The problem ``min_x 0.5||K x - y||^2 + lam ||D x||_{2,1}``.

    ``y``: (H, W) numpy data; ``taps``: the two 1-D blur kernels (rows,
    cols); ``centers``: their centres; ``mode``: boundary mode of the blur
    and of the gradient.  ``dtype`` defaults to ``y``'s.  Returns ``(f, h,
    K, solver, fit_kwargs)`` where ``fit_kwargs`` holds ``x0`` (default
    ``y``) and whichever of ``z0, tau, sigma, rho`` were given.
    """
    from pyxu_tpu_torch.operator.func import L21Norm, SquaredL2Norm
    from pyxu_tpu_torch.operator.linop import Gradient, Stencil
    from pyxu_tpu_torch.opt.solver import CondatVu

    dev, dt, yt = _data(y, dtype, device)
    H, W = yt.shape
    blur = Stencil((H, W), [np.asarray(t) for t in taps],
                   [int(c) for c in centers], mode=mode)
    f = 0.5 * SquaredL2Norm((H, W)).asloss(yt) * blur
    K = Gradient((H, W), mode=mode)
    h = lam * L21Norm((2, H, W), l2_axis=0)
    slv = CondatVu(f=f, h=h, K=K, **solver_kwargs)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    fit = {"x0": yt if x0 is None else tensor(x0).to(dt)}
    if z0 is not None:
        fit["z0"] = tensor(z0)
    fit.update({k: float(v) for k, v in
                (("tau", tau), ("sigma", sigma), ("rho", rho)) if v is not None})
    return f, h, K, slv, fit
