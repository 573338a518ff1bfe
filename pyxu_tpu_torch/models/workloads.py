"""Benchmark workloads as one-call factories (counterpart of
``pyxu_tpu/models/workloads.py``).

Ported: ``lasso_deconvolution`` (workload 1), ``tv_deconvolution`` (the
north-star workload) and ``radio_interferometry`` (workload 4).
``sparse_view_ct`` and ``consensus_tiles`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["lasso_deconvolution", "tv_deconvolution",
           "radio_interferometry"]


def _gauss1d(sigma, n):
    x = np.arange(n) - (n - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_op(shape, sigma=2.0, ksize=9, mode="symmetric"):
    from pyxu_tpu_torch.operator.linop import Stencil
    k1 = _gauss1d(sigma, ksize)
    c = (ksize - 1) // 2
    return Stencil(shape, [k1, k1], [c, c], mode=mode)


def lasso_deconvolution(shape=(256, 256), lam=0.05, seed=0, device=None,
                        **solver_kwargs):
    """Workload 1: Gaussian-blur deconvolution with an L1 prior, by FISTA.

    The sparse ground truth comes from ``numpy.random.default_rng(seed)``
    (the same bits as the JAX package's factory).  Runs on ``device``
    (default ``cuda``; raises when there is none).  ``solver_kwargs`` go to
    :class:`PGD` (e.g. ``stop_rate``).  Returns ``(solver, fit kwargs,
    extras)``; x0 = 0.
    """
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.opt.solver import PGD

    dev = resolve_device(device)
    shape = tuple(shape)
    rng = np.random.default_rng(seed)
    x_true = torch.from_numpy(
        (rng.random(shape) < 0.01).astype(np.float32)).to(dev)
    K = _blur_op(shape)
    y = K.apply(x_true)
    f = 0.5 * SquaredL2Norm(shape).asloss(y) * K
    g = lam * L1Norm(shape)
    slv = PGD(f=f, g=g, **solver_kwargs)
    return (slv, dict(x0=torch.zeros(shape, dtype=torch.float32, device=dev)),
            dict(x_true=x_true, y=y, K=K))


def tv_deconvolution(shape=(2160, 3840), lam=0.01, seed=0, device=None,
                     **solver_kwargs):
    """TV-regularized deconvolution solved by Condat-Vu (north star).

    The ground truth comes from ``numpy.random.default_rng(seed)`` (the same
    bits as the JAX package's factory).  Runs on ``device`` (default
    ``cuda``; raises when there is none).  ``solver_kwargs`` go to
    :class:`CondatVu` (e.g. ``stop_rate``).  Returns ``(solver, fit kwargs,
    extras)``.
    """
    from pyxu_tpu_torch.operator.func import L21Norm, SquaredL2Norm
    from pyxu_tpu_torch.operator.linop import Gradient
    from pyxu_tpu_torch.opt.solver import CondatVu

    dev = resolve_device(device)
    shape = tuple(shape)
    rng = np.random.default_rng(seed)
    x_true = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    K = _blur_op(shape)
    y = K.apply(x_true)
    f = 0.5 * SquaredL2Norm(shape).asloss(y) * K
    D = Gradient(shape, mode="symmetric")
    h = lam * L21Norm((2,) + shape, l2_axis=0)
    slv = CondatVu(f=f, h=h, K=D, **solver_kwargs)
    return slv, dict(x0=y), dict(x_true=x_true, y=y, K=K, D=D)


def radio_interferometry(shape=(256, 256), n_vis=5000, lam=0.02, seed=0,
                         real_sky: bool = True, device=None,
                         **solver_kwargs):
    """Workload 4: radio interferometry, a 2-D type-2 NUFFT forward model
    with an L1 prior, solved by ADMM.

    The sky (30 point sources) and the uv coverage (a Gaussian of sigma
    pi/3, clipped to [-pi, pi]) come from ``numpy.random.default_rng(seed)``
    in the JAX package's order, so one seed gives both packages the same
    problem.  ``real_sky``: a real image and a real-input NUFFT (the gram's
    apply runs on the rfft half spectrum); else a complex image as a
    ``(..., 2)`` real view.  The loss ``0.5 ||A x - y||^2`` becomes a
    quadratic over the Toeplitz gram, so the ADMM iterations run FFTs only;
    the NUFFT kernels run while the problem is set up (the grams' builds,
    ``y = A x_true`` and the loss's constant gradient).  Runs on ``device``
    (default ``cuda``; raises when there is none) in float32.
    ``solver_kwargs`` go to :class:`ADMM` (e.g. ``stop_rate``).  Returns
    ``(solver, fit kwargs, extras)``; x0 = 0, tau = 0.05, inner CG maxiter
    3.
    """
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.opt.solver import ADMM

    dev = resolve_device(device)
    shape = tuple(shape)
    rng = np.random.default_rng(seed)
    x_true = np.zeros(shape, np.float32)
    rows = rng.integers(0, shape[0], 30)
    cols = rng.integers(0, shape[1], 30)
    x_true[rows, cols] = rng.random(30).astype(np.float32)
    uv = rng.normal(0, np.pi / 3, (n_vis, 2)).clip(-np.pi, np.pi)
    A = NUFFT.type2(uv.astype(np.float32), shape, eps=1e-6, real=real_sky,
                    dtype=torch.float32, device=dev)
    A.estimate_lipschitz(maxiter=32, dtype=torch.float32, device=dev)
    if real_sky:
        xt = torch.from_numpy(x_true).to(dev)
        dom = shape
    else:
        xt = torch.from_numpy(
            np.stack([x_true, np.zeros_like(x_true)], axis=-1)).to(dev)
        dom = shape + (2,)
    y = A.apply(xt)
    f = 0.5 * SquaredL2Norm((n_vis, 2)).asloss(y) * A
    h = lam * L1Norm(dom)
    slv = ADMM(f=f, h=h, solver_kwargs=dict(maxiter=3), **solver_kwargs)
    return (slv, dict(x0=torch.zeros(dom, dtype=torch.float32, device=dev),
                      tau=0.05),
            dict(x_true=x_true, y=y, A=A, uv=uv))
