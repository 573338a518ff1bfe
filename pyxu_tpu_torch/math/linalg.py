"""Spectral machinery: power iteration, subspace-iteration SVD, traces
(counterpart of ``pyxu_tpu/math/linalg.py``).

Each function runs on ``device`` (default ``cuda``, which must exist) in
``dtype`` (default: the precision policy's float dtype).  Random starts come
from ``generator``, a ``torch.Generator`` on that device; when none is
given, one is seeded with the JAX package's default key number (17, 19,
23), so a call never reads global random state.  The numbers differ from
``jax.random``'s: the estimates agree with the JAX package's to the
methods' accuracy, not bit for bit.  Iterations stay on the device; only
the result is read back.
"""

from __future__ import annotations

import torch

from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["spectral_norm", "svdvals", "trace", "hutchpp", "norm"]


def _setup(dtype, device, generator, seed: int):
    dev = resolve_device(device)
    dt = default_fdtype() if dtype is None else dtype
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return dev, dt, generator


def _flat_apply(op, core_shape):
    """op.apply lifted to rows of flattened probes: (m, N) -> (m, M)."""
    def fn(V):
        Y = op.apply(V.reshape((V.shape[0],) + tuple(core_shape)))
        return Y.reshape(V.shape[0], -1)
    return fn


def spectral_norm(op, generator=None, maxiter: int = 64, dtype=None,
                  device=None) -> float:
    """||op||_2 by ``maxiter`` steps of power iteration on ``op.gram()``."""
    dev, dt, gen = _setup(dtype, device, generator, 17)
    gram = op.gram()
    tiny = torch.finfo(dt).tiny
    with torch.no_grad():
        v = torch.randn(op.dim_shape, generator=gen, dtype=dt, device=dev)
        v = v / torch.linalg.vector_norm(v)
        for _ in range(int(maxiter)):
            w = gram.apply(v).to(dt)
            v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
        lam = torch.sum(v * gram.apply(v))
        return float(torch.sqrt(torch.clamp(lam, min=0.0)))


def svdvals(op, k: int = 1, generator=None, maxiter: int = 96, dtype=None,
            device=None) -> torch.Tensor:
    """Top-k singular values in ascending order, by subspace iteration and
    QR on the Gram operator."""
    dev, dt, gen = _setup(dtype, device, generator, 19)
    n = op.dim_size
    k = min(int(k), n)
    gram_flat = _flat_apply(op.gram(), op.dim_shape)
    with torch.no_grad():
        V = torch.randn((k, n), generator=gen, dtype=dt, device=dev)
        V, _ = torch.linalg.qr(V.T)                     # (n, k)
        for _ in range(int(maxiter)):
            V, _ = torch.linalg.qr(gram_flat(V.T).T.to(dt))
        B = gram_flat(V.T).T
        Hm = V.T @ B
        lam = torch.linalg.eigvalsh((Hm + Hm.T) / 2)
        return torch.sqrt(torch.clamp(lam, min=0.0))


def trace(op, dtype=None, device=None, block: int = 2048) -> float:
    """Exact trace by probing with basis vectors, ``block`` at a time."""
    if op.dim_size != op.codim_size:
        raise ValueError(f"trace requires a square operator, got dim "
                         f"{op.dim_size} != codim {op.codim_size}")
    dev = resolve_device(device)
    dt = default_fdtype() if dtype is None else dtype
    n = op.dim_size
    flat = _flat_apply(op, op.dim_shape)
    total = 0.0
    with torch.no_grad():
        for i0 in range(0, n, block):
            idx = torch.arange(i0, min(i0 + block, n), device=dev)
            E = torch.zeros((len(idx), n), dtype=dt, device=dev)
            E[torch.arange(len(idx), device=dev), idx] = 1.0
            Y = flat(E)
            total += float(Y[torch.arange(len(idx), device=dev), idx].sum())
    return total


def hutchpp(op, m: int = 126, generator=None, dtype=None,
            device=None) -> float:
    """Hutch++ stochastic trace estimate with ``m // 3`` probes per stage:
    tr(Q^T A Q) + tr(G^T (I-QQ^T) A (I-QQ^T) G) / c."""
    dev, dt, gen = _setup(dtype, device, generator, 23)
    n = op.dim_size
    c = max(min(m // 3, n), 1)
    flat = _flat_apply(op, op.dim_shape)

    def rademacher():
        r = torch.randint(0, 2, (n, c), generator=gen, device=dev)
        return (2 * r - 1).to(dt)

    with torch.no_grad():
        S, G = rademacher(), rademacher()
        Q, _ = torch.linalg.qr(flat(S.T).T)
        t1 = torch.trace(Q.T @ flat(Q.T).T)
        Gp = G - Q @ (Q.T @ G)
        AGp = flat(Gp.T).T
        t2 = torch.trace(Gp.T @ (AGp - Q @ (Q.T @ AGp))) / c
        return float(t1 + t2)


def norm(arr, ord=None):
    """Norm of the flattened array."""
    return torch.linalg.vector_norm(torch.as_tensor(arr).reshape(-1),
                                    ord=2 if ord is None else ord)
