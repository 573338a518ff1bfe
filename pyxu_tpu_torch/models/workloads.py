"""Benchmark workloads as one-call factories (counterpart of
``pyxu_tpu/models/workloads.py``).

All five: ``lasso_deconvolution`` (workload 1), ``tv_deconvolution`` (the
north-star workload), ``sparse_view_ct`` (workload 3),
``radio_interferometry`` (workload 4) and ``consensus_tiles`` (workload 5).
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["lasso_deconvolution", "tv_deconvolution", "sparse_view_ct",
           "radio_interferometry", "consensus_tiles"]


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


def sparse_view_ct(shape=(128, 128), n_angles=30, lam=0.05, seed=0,
                   method: str = "interp", device=None, **solver_kwargs):
    """Workload 3: sparse-view CT, a parallel-beam Radon transform with a
    positivity constraint and a TV prior, solved by PD3O::

        min_x 0.5 ||A x - y||^2 + i_{x >= 0}(x) + lam ||D x||_{2,1}

    The phantom is MATLAB's ``peaks`` on [-2.5, 2.5]^2, clipped at 0 and
    scaled to a peak of 1; the ``n_angles`` views are evenly spaced over
    [0, pi).  ``method="interp"``: :class:`RadonTransform` (a bilinear
    gather); ``"fourier"``: :class:`FourierRadon`, whose gram is FFTs
    only, so the iterations run no NUFFT: its spread and interp kernels run
    in the set-up (the grams' Toeplitz builds, ``y = A x_true`` and the
    loss's constant gradient A^T y).  ``||A||`` is estimated by 32 power
    steps from a generator seeded with ``seed``.  Runs on ``device``
    (default ``cuda``; raises when there is none) in float32.
    ``solver_kwargs`` go to :class:`PD3O` (e.g. ``stop_rate``).  Returns
    ``(solver, fit kwargs, extras)``; x0 = 0.
    """
    from pyxu_tpu_torch.operator.linop.xray import (FourierRadon,
                                                    RadonTransform)
    from pyxu_tpu_torch.utils.misc import peaks
    from pyxu_tpu_torch.utils.profiler import span

    dev = resolve_device(device)
    shape = tuple(shape)
    H, W = shape
    yy, xx = np.meshgrid(np.linspace(-2.5, 2.5, H),
                         np.linspace(-2.5, 2.5, W), indexing="ij")
    x_true = torch.clamp(peaks(torch.from_numpy(xx), torch.from_numpy(yy)),
                         min=0)
    x_true = (x_true / x_true.max()).to(device=dev, dtype=torch.float32)
    angles = np.linspace(0, np.pi, n_angles, endpoint=False)
    op = FourierRadon if method == "fourier" else RadonTransform
    with span("ct.A"):
        A = op(shape, angles, dtype=torch.float32, device=dev)
    with span("ct.lipschitz_estimate"):
        A.estimate_lipschitz(
            maxiter=32, generator=torch.Generator(device=dev).manual_seed(
                seed), dtype=torch.float32, device=dev)
    with span("ct.y"):
        y = A.apply(x_true)
    _, _, _, D, slv = ct_pd3o(A, y, lam, **solver_kwargs)
    return (slv, dict(x0=torch.zeros(shape, dtype=torch.float32, device=dev)),
            dict(x_true=x_true, y=y, A=A, D=D))


def ct_pd3o(A, y, lam, **solver_kwargs):
    """The sparse-view CT problem over the Radon operator ``A`` and the
    sinogram ``y``: ``f = 0.5 ||A . - y||^2``, ``g`` the positive orthant,
    ``K`` the symmetric-mode gradient and ``h = lam ||.||_{2,1}``, solved by
    :class:`PD3O` (``solver_kwargs``).  Returns ``(f, g, h, K, solver)``."""
    from pyxu_tpu_torch.operator.func import (L21Norm, PositiveOrthant,
                                              SquaredL2Norm)
    from pyxu_tpu_torch.operator.linop import Gradient
    from pyxu_tpu_torch.opt.solver import PD3O
    from pyxu_tpu_torch.utils.profiler import span

    shape = A.dim_shape
    with span("ct.loss"):
        f = 0.5 * SquaredL2Norm(A.codim_shape).asloss(y) * A
    g = PositiveOrthant(shape)
    K = Gradient(shape, mode="symmetric")
    h = lam * L21Norm((2,) + shape, l2_axis=0)
    return f, g, h, K, PD3O(f=f, g=g, h=h, K=K, **solver_kwargs)


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


def consensus_tiles(tile=(512, 512), n_tiles=8, lam=0.02, seed=0, mesh=None,
                    device=None):
    """Workload 5: a giga-pixel image as B tiles, consensus ADMM over a
    mesh.

    Tile b's data ``y_b`` is ``numpy.random.default_rng(seed).random(tile,
    float32)``, drawn in tile order (the JAX package's bits);
    ``f_b = SquaredL2Norm.asloss(y_b)``, ``g = B lam L1Norm``.  ``mesh``:
    a ``DeviceMesh`` whose first axis cuts the tiles; None takes
    ``auto_mesh()`` over every rank when a process group is up, else the
    single-process solver.  Runs on ``device`` (default ``cuda``; raises
    when there is none) in float32.  Returns ``(solver, fit kwargs,
    extras)``; z0 = 0.
    """
    import torch.distributed as dist

    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    from pyxu_tpu_torch.parallel import ConsensusADMM, auto_mesh

    dev = resolve_device(device)
    tile = tuple(tile)
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = auto_mesh(device=dev)
    rng = np.random.default_rng(seed)
    ys = [torch.from_numpy(rng.random(tile, dtype=np.float32)).to(dev)
          for _ in range(n_tiles)]
    fs = [SquaredL2Norm(tile).asloss(y) for y in ys]
    g = (n_tiles * lam) * L1Norm(tile)
    slv = ConsensusADMM(fs, g=g, mesh=mesh)
    return slv, dict(z0=torch.zeros(tile, device=dev)), dict(ys=ys)
