"""Iterative-solver engine (counterpart of ``pyxu_tpu/abc/solver.py``).

``fit`` runs the solve in *segments* of ``stop_rate`` steps.  After each
segment the stop criterion is evaluated on the device and the host makes
one read: the stop flag.  The per-segment metrics stay on the device until
``stats()`` asks for the history.

Subclass contract:

* ``m_init(**kwargs) -> mstate``  — a dict of tensors;
* ``m_step(mstate) -> mstate``    — one iteration, returning new tensors;
* ``default_stop_crit()``;
* ``objective_func(mstate)``      — optional.

A solver may install a multi-step hook: ``self._m_step2`` advances
``self._m_step2_iters`` exact iterations in one call (the fused TV K-step
kernel).  A segment then runs ``stop_rate // k`` multi-steps followed by
``stop_rate % k`` single steps.

Ported: BLOCK mode (``fit`` returns when the solve has stopped).
MANUAL/ASYNC modes, ``track_objective``, checkpoints, ``warm_start``,
``precision_schedule``, ``update_operands`` and CUDA-graph segments are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.opt.stop import RelError, StoppingCriterion

__all__ = ["Solver", "StoppingCriterion"]


class Solver:
    """Iterative solver skeleton."""

    def __init__(self, *, stop_rate: int = 1):
        if int(stop_rate) <= 0:
            raise ValueError(f"stop_rate must be positive, got {stop_rate}")
        self._stop_rate = int(stop_rate)
        self._mstate: dict = {}
        self._records: list = []
        self._m_step2 = None
        self._m_step2_iters = 0

    # ------------------------------------------------------------ subclass --
    def m_init(self, **kwargs) -> dict:
        raise NotImplementedError

    def m_step(self, mstate: dict) -> dict:
        raise NotImplementedError

    def default_stop_crit(self) -> StoppingCriterion:
        return RelError(eps=1e-4, var="x")

    def objective_func(self, mstate: dict):
        raise NotImplementedError

    # ----------------------------------------------------------------- fit --
    def fit(self, *, stop_crit: StoppingCriterion = None,
            max_iter: int = 10_000, **m_init_kwargs):
        """Solve; ``max_iter`` is a hard cap checked between segments."""
        stop = stop_crit if stop_crit is not None else self.default_stop_crit()
        self._mstate = self.m_init(**m_init_kwargs)
        mstate = self._mstate
        cstate = stop.init_state(mstate)
        step2, kk = self._m_step2, int(self._m_step2_iters or 0)
        n2, n1 = ((self._stop_rate // kk, self._stop_rate % kk)
                  if step2 is not None and self._stop_rate >= kk
                  else (0, self._stop_rate))
        self._records = []
        k = 0
        with torch.no_grad():
            while k < int(max_iter):
                for _ in range(n2):
                    mstate = step2(mstate)
                for _ in range(n1):
                    mstate = self.m_step(mstate)
                k += self._stop_rate
                cstate, stop_now, metrics = stop.update(cstate, mstate, k)
                self._records.append({"iteration": k, **metrics})
                self._mstate = mstate
                if bool(stop_now):     # the one host read of the segment
                    break
        return self

    # ------------------------------------------------------------- results --
    def solution(self):
        return self._mstate.get("x")

    def stats(self):
        """(mstate dict, history structured array), one row per segment."""
        if not self._records:
            return self._mstate, None
        names = list(self._records[0])
        cols = {}
        for n in names:
            vals = [r[n] for r in self._records]
            if isinstance(vals[0], torch.Tensor):
                vals = torch.stack(vals).cpu().numpy()
            cols[n] = np.asarray(vals)
        out = np.empty(len(self._records),
                       dtype=[(n, cols[n].dtype) for n in names])
        for n in names:
            out[n] = cols[n]
        return self._mstate, out

