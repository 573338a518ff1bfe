"""Composable stopping criteria (counterpart of ``pyxu_tpu/opt/stop.py``).

A criterion has a *device part* and an optional *host part*.

The device part is ``init_state(mstate)`` and ``update(cstate, mstate, k)
-> (cstate', stop, metrics)``.  ``stop`` is a 0-d bool tensor on the
state's device, or a Python bool where the host already knows the answer
(``MaxIter``: ``k`` is a host integer); ``metrics`` is a dict of 0-d
tensors or numpy scalars, one history column each.  The solver reads a
tensor ``stop`` back once per block of ``stop_rate`` steps and never reads
a Python one.

The host part (``host_init``, ``host_check``, ``refresh_host``,
``host_metrics``, ``has_host_part``) holds wall-clock and carbon budgets.
The solver consults it between segments; ``refresh_host`` latches a
host-side firing into the carry, so that ``MaxDuration(...) &
AbsError(...)`` combines a host-only with a device-only condition.

Criteria compose with ``&`` (stop when both) and ``|`` (stop when either).
``clear`` / ``stop`` / ``info`` run a criterion eagerly, one state at a
time, in the reference's protocol.
"""

from __future__ import annotations

import datetime as dt
import time

import numpy as np
import torch

__all__ = [
    "StoppingCriterion",
    "MaxIter",
    "ManualStop",
    "MaxDuration",
    "MaxCarbon",
    "Memorize",
    "AbsError",
    "RelError",
]


def _or(a, b):
    """Logical or of two stop flags, each a Python bool or a 0-d tensor;
    a Python ``True`` on either side decides with no device work."""
    if isinstance(a, bool):
        return True if a else b
    if isinstance(b, bool):
        return True if b else a
    return torch.logical_or(a, b)


def _and(a, b):
    """Logical and of two stop flags (see :func:`_or`)."""
    if isinstance(a, bool):
        return b if a else False
    if isinstance(b, bool):
        return a if b else False
    return torch.logical_and(a, b)


class StoppingCriterion:
    """Device and host protocol (see the module docstring)."""

    def init_state(self, mstate):
        return ()

    def update(self, cstate, mstate, k: int):
        return cstate, False, {}

    # -- host part, consulted between segments ------------------------------
    def host_init(self) -> None:
        pass

    def host_check(self) -> bool:
        return False

    def refresh_host(self, cstate):
        """Latch host-side firing into the carry at a segment's end."""
        return cstate

    def host_metrics(self) -> dict:
        return {}

    def has_host_part(self) -> bool:
        """True when the criterion (or a part of it) can fire only on the
        host: the solver then bounds its segments so that it is consulted
        during the solve."""
        return False

    def cache_key(self):
        """The JAX package keys its compiled segments by this; the port
        compiles none, so every criterion keeps the default, its
        identity."""
        return id(self)

    # -- the reference's protocol, eager -------------------------------------
    def clear(self) -> None:
        """Reset the state before a fresh run."""
        self.host_init()
        self._eager = {"cstate": None, "k": 0, "metrics": {}}

    def stop(self, state: dict) -> bool:
        """Evaluate the criterion on one math-state dict."""
        if getattr(self, "_eager", None) is None:
            self.clear()
        e = self._eager
        if e["cstate"] is None:
            e["cstate"] = self.init_state(state)
        cs = self.refresh_host(e["cstate"])
        cs, s, m = self.update(cs, state, e["k"])
        e["cstate"] = cs
        e["k"] += 1
        e["metrics"] = {k: _host_array(v) for k, v in m.items()}
        e["metrics"].update(self.host_metrics())
        return bool(s) or bool(self.host_check())

    def info(self) -> dict:
        """The metrics of the last :meth:`stop` call, one float each."""
        e = getattr(self, "_eager", None) or {"metrics": {}}
        return {k: float(v) for k, v in e["metrics"].items()}

    def __and__(self, other: "StoppingCriterion") -> "StoppingCriterion":
        return _Combined(self, other, all_of=True)

    def __or__(self, other: "StoppingCriterion") -> "StoppingCriterion":
        return _Combined(self, other, all_of=False)


def _host_array(v):
    """A tensor (or number) as a numpy array on the host; bfloat16 is
    widened to float32, which numpy has no type for."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


class _Combined(StoppingCriterion):
    """A leaf fires when its device stop or its latched host check is true;
    ``&`` / ``|`` combine the leaves' firing.  The host flags ride in the
    carry as Python bools, set by :meth:`refresh_host` once a segment."""

    def __init__(self, lhs, rhs, all_of: bool):
        self._lhs, self._rhs, self._all = lhs, rhs, all_of

    def init_state(self, mstate):
        return (self._lhs.init_state(mstate), self._rhs.init_state(mstate),
                (False, False))

    def update(self, cstate, mstate, k):
        cl, sl, ml = self._lhs.update(cstate[0], mstate, k)
        cr, sr, mr = self._rhs.update(cstate[1], mstate, k)
        hl, hr = cstate[2]
        fl, fr = _or(sl, hl), _or(sr, hr)
        stop = _and(fl, fr) if self._all else _or(fl, fr)
        # identical metric names from both sides (two RelError[x] legs) are
        # kept apart, not overwritten
        metrics = dict(ml)
        for name, val in mr.items():
            while name in metrics:
                name = name + "'"
            metrics[name] = val
        return (cl, cr, (hl, hr)), stop, metrics

    def host_init(self):
        self._lhs.host_init()
        self._rhs.host_init()

    def host_check(self) -> bool:
        hl, hr = self._lhs.host_check(), self._rhs.host_check()
        return (hl and hr) if self._all else (hl or hr)

    def refresh_host(self, cstate):
        return (self._lhs.refresh_host(cstate[0]),
                self._rhs.refresh_host(cstate[1]),
                (bool(self._lhs.host_check()), bool(self._rhs.host_check())))

    def host_metrics(self) -> dict:
        return {**self._lhs.host_metrics(), **self._rhs.host_metrics()}

    def has_host_part(self) -> bool:
        return self._lhs.has_host_part() or self._rhs.has_host_part()


class MaxIter(StoppingCriterion):
    """Stop after n iterations.  Decided on the host: ``k`` is a host
    integer, so this criterion costs no device work and no read."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"MaxIter needs n > 0, got {n}")
        self._n = int(n)

    def update(self, cstate, mstate, k):
        return cstate, k >= self._n, {"N_iter": np.int32(k)}


class ManualStop(StoppingCriterion):
    """Never stops on its own: an ASYNC fit that the user interrupts with
    ``Solver.stop()``."""


class MaxDuration(StoppingCriterion):
    """Wall-clock budget, checked on the host between segments."""

    def __init__(self, t: dt.timedelta):
        self._budget = t.total_seconds() if isinstance(t, dt.timedelta) \
            else float(t)
        self._t0 = None

    def host_init(self):
        self._t0 = time.monotonic()

    def host_check(self) -> bool:
        return (time.monotonic() - self._t0) >= self._budget

    def host_metrics(self) -> dict:
        return {"duration": time.monotonic() - (self._t0 or time.monotonic())}

    def has_host_part(self) -> bool:
        return True


class MaxCarbon(MaxDuration):
    """CO2-equivalent budget from a constant power model:
    kgCO2 = watts * hours * intensity / 1e6.

    ``watts`` defaults to the power limit of the card the port runs on,
    ``NVIDIA H100 80GB HBM3, 700.00 W`` as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives it; pass the limit of another
    card (or its measured draw) explicitly.
    """

    def __init__(self, budget_kg: float, watts: float = 700.0,
                 intensity_g_per_kwh: float = 475.0):
        seconds = budget_kg / (watts * intensity_g_per_kwh / 1e6 / 3600.0)
        super().__init__(seconds)
        self._watts = watts
        self._intensity = intensity_g_per_kwh

    def host_metrics(self) -> dict:
        el = time.monotonic() - (self._t0 or time.monotonic())
        return {"carbon_kg": self._watts * (el / 3600.0)
                * self._intensity / 1e6}


class Memorize(StoppingCriterion):
    """Record a variable at every check; never stops.  A non-scalar
    variable is recorded by its L2 norm."""

    def __init__(self, var: str = "x"):
        self._var = var

    def update(self, cstate, mstate, k):
        v = mstate[self._var]
        val = v if v.ndim == 0 else torch.sqrt(torch.sum(v * v))
        return cstate, False, {f"Memorize[{self._var}]": val}


def _batched_norm(v, rank: int, ord):
    """Per-batch-element norm over the trailing ``rank`` axes."""
    if not 0 <= rank <= v.ndim:
        raise ValueError(
            f"rank={rank} incompatible with a variable of ndim {v.ndim}: "
            "rank counts the trailing axes that form one solution point")
    axes = tuple(range(v.ndim - rank, v.ndim))
    if not axes:
        return torch.abs(v) if ord != 2 else torch.sqrt(v * v)
    if ord == 2:
        return torch.sqrt(torch.sum(v * v, dim=axes))
    if ord in (float("inf"), "inf"):
        return torch.amax(torch.abs(v), dim=axes)
    if ord == 1:
        return torch.sum(torch.abs(v), dim=axes)
    return torch.sum(torch.abs(v) ** ord, dim=axes) ** (1.0 / ord)


class AbsError(StoppingCriterion):
    """Stop when ||f(var)|| <= eps; ``rank`` = trailing axes forming one
    solution, ``satisfy_all`` = all vs any over the batch."""

    def __init__(self, eps: float, var: str = "x", rank: int = None, f=None,
                 norm=2, satisfy_all: bool = True):
        self._eps = float(eps)
        self._var = var
        self._rank = rank
        self._f = f
        self._norm = norm
        self._all = satisfy_all

    def update(self, cstate, mstate, k):
        v = mstate[self._var]
        if self._f is not None:
            v = self._f(v)
        rank = v.ndim if self._rank is None else self._rank
        val = _batched_norm(v, rank, self._norm)
        ok = val <= self._eps
        stop = torch.all(ok) if self._all else torch.any(ok)
        return cstate, stop, {f"AbsError[{self._var}]": torch.max(val)}


class RelError(StoppingCriterion):
    """Stop when ||x_k - x_{k-1}|| <= eps ||x_{k-1}||; a diverged (non-
    finite) iterate stops too."""

    def __init__(self, eps: float, var: str = "x", rank: int = None, f=None,
                 norm=2, satisfy_all: bool = True):
        self._eps = float(eps)
        self._var = var
        self._rank = rank
        self._f = f
        self._norm = norm
        self._all = satisfy_all

    def _value(self, mstate):
        v = mstate[self._var]
        return self._f(v) if self._f is not None else v

    def init_state(self, mstate):
        v = self._value(mstate)
        return {"prev": torch.zeros_like(v),
                "have": torch.zeros((), dtype=torch.bool, device=v.device)}

    def update(self, cstate, mstate, k):
        v = self._value(mstate)
        rank = v.ndim if self._rank is None else self._rank
        prev = cstate["prev"]
        num = _batched_norm(v - prev, rank, self._norm)
        den = _batched_norm(prev, rank, self._norm)
        val = num / torch.clamp(den, min=torch.finfo(v.dtype).tiny)
        valid = cstate["have"]
        ok = val <= self._eps
        stop = torch.logical_and(torch.all(ok) if self._all else torch.any(ok),
                                 valid)
        diverged = torch.logical_not(torch.all(torch.isfinite(v)))
        stop = torch.logical_or(stop, torch.logical_and(diverged, valid))
        # the scalar fill stays on the device: no host-to-device copy
        metric = torch.where(valid, torch.max(val), float("inf"))
        # solver steps return new tensors, so keeping a reference is a copy
        return ({"prev": v, "have": torch.ones_like(valid)}, stop,
                {f"RelError[{self._var}]": metric})
