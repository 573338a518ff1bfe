"""Benchmark workloads as one-call factories (counterpart of
``pyxu_tpu/models/workloads.py``).

Ported: ``lasso_deconvolution`` (workload 1) and ``tv_deconvolution`` (the
north-star workload).  The other three factories are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["lasso_deconvolution", "tv_deconvolution"]


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
