"""Composable stopping criteria evaluated on the device (counterpart of
``pyxu_tpu/opt/stop.py``).

A criterion's device part is ``init_state(mstate)`` and ``update(cstate,
mstate, k) -> (cstate', stop, metrics)``, where ``stop`` is a 0-d bool
tensor and ``metrics`` a dict of 0-d tensors, all on the state's device:
the solver reads them back once per segment.  Criteria compose with ``&``
(stop when both) and ``|`` (stop when either).

Ported: MaxIter, AbsError, RelError and the combinators.  The host-only
criteria (MaxDuration, MaxCarbon), ManualStop and Memorize are not ported
yet.
"""

from __future__ import annotations

import torch

__all__ = ["StoppingCriterion", "MaxIter", "AbsError", "RelError"]


class StoppingCriterion:
    """Device-side protocol (see module docstring)."""

    def init_state(self, mstate):
        return ()

    def update(self, cstate, mstate, k: int):
        raise NotImplementedError

    def __and__(self, other: "StoppingCriterion") -> "StoppingCriterion":
        return _Combined(self, other, all_of=True)

    def __or__(self, other: "StoppingCriterion") -> "StoppingCriterion":
        return _Combined(self, other, all_of=False)


class _Combined(StoppingCriterion):

    def __init__(self, lhs, rhs, all_of: bool):
        self._lhs, self._rhs, self._all = lhs, rhs, all_of

    def init_state(self, mstate):
        return (self._lhs.init_state(mstate), self._rhs.init_state(mstate))

    def update(self, cstate, mstate, k):
        cl, sl, ml = self._lhs.update(cstate[0], mstate, k)
        cr, sr, mr = self._rhs.update(cstate[1], mstate, k)
        stop = torch.logical_and(sl, sr) if self._all \
            else torch.logical_or(sl, sr)
        # identical metric names from both sides (two RelError[x] legs) are
        # kept apart, not overwritten
        metrics = dict(ml)
        for name, val in mr.items():
            while name in metrics:
                name = name + "'"
            metrics[name] = val
        return (cl, cr), stop, metrics


def _device_of(mstate) -> torch.device:
    return next(iter(mstate.values())).device


class MaxIter(StoppingCriterion):
    """Stop after n iterations."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"MaxIter needs n > 0, got {n}")
        self._n = int(n)

    def update(self, cstate, mstate, k):
        dev = _device_of(mstate)
        return (cstate, torch.tensor(k >= self._n, device=dev),
                {"N_iter": torch.tensor(k, dtype=torch.int32, device=dev)})


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
                "have": torch.tensor(False, device=v.device)}

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
        metric = torch.where(valid, torch.max(val),
                             torch.tensor(float("inf"), dtype=val.dtype,
                                          device=val.device))
        # solver steps return new tensors, so keeping a reference is a copy
        return ({"prev": v, "have":torch.ones_like(valid)}, stop,
                {f"RelError[{self._var}]": metric})
