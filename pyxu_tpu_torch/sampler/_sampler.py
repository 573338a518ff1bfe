"""MCMC samplers for uncertainty quantification (counterpart of
``pyxu_tpu/sampler/_sampler.py``).

``samples(x0, seed)`` is an endless generator of the chain's states, one
step a draw; ``run(x0, n, seed, thin, burn_in)`` returns ``n`` of them
stacked ``(n, *shape)``.  The chain runs on ``x0``'s device (a host array
goes to ``cuda``, as every entry point's input does).  Its noise comes
from a ``torch.Generator`` on that device seeded with ``seed``, never from
global random state; the draws differ from ``jax.random``'s.

A step is split in two: ``_step(x, generator)`` draws the noise ``w`` and
calls ``_update(x, w)``, which is deterministic, so that the same noise can
be fed to this package, to the JAX package and to either device.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["Sampler", "_Sampler", "ULA", "MYULA"]


def _state(x0) -> torch.Tensor:
    if isinstance(x0, torch.Tensor):
        return x0
    return torch.from_numpy(np.asarray(x0)).to(resolve_device())


class Sampler:
    """The generator protocol."""

    def _update(self, x, w):
        raise NotImplementedError

    def _step(self, x, generator):
        w = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
        return self._update(x, w)

    @staticmethod
    def _generator(x, seed: int) -> torch.Generator:
        return torch.Generator(device=x.device).manual_seed(int(seed))

    def samples(self, x0, seed: int = 0):
        """Endless generator of samples, one step a draw."""
        x = _state(x0)
        gen = self._generator(x, seed)
        while True:
            x = self._step(x, gen)
            yield x

    def run(self, x0, n: int, seed: int = 0, thin: int = 1,
            burn_in: int = 0) -> torch.Tensor:
        """``n`` samples stacked ``(n, *shape)``: ``burn_in`` discarded
        draws first, then ``n`` kept ones, each draw ``thin`` steps (the
        JAX package's schedule, ``(burn_in + n) * thin`` steps in all)."""
        x = _state(x0)
        gen = self._generator(x, seed)
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        for i in range(burn_in + n):
            for _ in range(thin):
                x = self._step(x, gen)
            if i >= burn_in:
                out[i - burn_in] = x
        return out


class ULA(Sampler):
    r"""Unadjusted Langevin: x+ = x - gamma grad F(x) + sqrt(2 gamma) w.

    ``gamma`` defaults to 0.98 / beta, beta F's diff-Lipschitz constant
    (estimated when it is not declared)."""

    def __init__(self, f, gamma: float = None):
        self._f = f
        if gamma is None:
            beta = f.diff_lipschitz
            if not _math.isfinite(beta) or beta == 0:
                beta = f.estimate_diff_lipschitz()
            gamma = 0.98 / beta
        self._gamma = float(gamma)

    @property
    def gamma(self) -> float:
        return self._gamma

    def _update(self, x, w):
        g = self._gamma
        return x - g * self._f.grad(x) + _math.sqrt(2 * g) * w

    def objective_func(self, x):
        return self._f.apply(x)


class MYULA(ULA):
    r"""ULA on the Moreau-Yosida smoothing of f + g: the drift is
    grad f(x) + (x - prox_{lamb g}(x)) / lamb.

    ``lamb`` defaults to min(2, 1 / beta_f) (2 when beta_f = 0), ``gamma``
    to 0.98 / (beta_f + 1 / lamb), beta_f f's diff-Lipschitz constant
    (estimated when it is not declared).  ``f = None`` is the constant 0.
    """

    def __init__(self, f=None, g=None, gamma: float = None,
                 lamb: float = None):
        from pyxu_tpu_torch.operator.map.base import ConstantValued
        assert f is not None or g is not None
        dim_shape = (f or g).dim_shape
        if f is None:
            f = ConstantValued(dim_shape, (), 0.0)
        self._g = g
        beta_f = f.diff_lipschitz if _math.isfinite(f.diff_lipschitz) else \
            f.estimate_diff_lipschitz()
        if lamb is None:
            lamb = 2.0 if beta_f == 0 else min(2.0, 1.0 / beta_f)
        self._lamb = float(lamb)
        beta = beta_f + 1.0 / self._lamb
        if gamma is None:
            gamma = 0.98 / beta
        self._f = f
        self._gamma = float(gamma)

    @property
    def lamb(self) -> float:
        return self._lamb

    def _drift(self, x):
        drift = self._f.grad(x)
        if self._g is not None:
            drift = drift + (x - self._g.prox(x, self._lamb)) / self._lamb
        return drift

    def _update(self, x, w):
        g = self._gamma
        return x - g * self._drift(x) + _math.sqrt(2 * g) * w

    def objective_func(self, x):
        """Negative log-target: f plus the Moreau envelope of g."""
        val = self._f.apply(x)
        if self._g is not None:
            p = self._g.prox(x, self._lamb)
            d = (x - p).reshape(-1)
            val = val + self._g.apply(p) + (d @ d) / (2.0 * self._lamb)
        return val


#: The generator protocol under the reference's private name.
_Sampler = Sampler
