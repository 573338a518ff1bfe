"""Iterative-solver engine (counterpart of ``pyxu_tpu/abc/solver.py``).

``fit`` runs the solve in *blocks* of ``stop_rate`` steps.  After each block
the stop criterion is evaluated on the device, its metrics are written into
a history kept on the device (``max_iter // stop_rate + 2`` rows), and the
host makes one read: the stop flag (none where the criterion decides on the
host, as ``MaxIter`` does).  Blocks group into *segments* of
``segment_size`` iterations; only at a segment's end does the host log,
write a checkpoint, consult host-side criteria (wall clock, carbon) and
look for an ASYNC ``stop()``.  PyTorch runs eagerly, so there is no
compiled segment to key or cache.

Subclass contract:

* ``m_init(**kwargs) -> mstate``  — a dict of tensors;
* ``m_step(mstate) -> mstate``    — one iteration, returning new tensors;
* ``default_stop_crit()``;
* ``objective_func(mstate)``      — optional, for ``track_objective``;
* ``_m_refresh(mstate)``          — optional: re-derive what ``m_init``
  decided from the state (``CondatVu``'s fusion match) when a fit skips
  ``m_init`` (``warm_start``, the phases of a ``precision_schedule``).

A solver may install a multi-step hook: ``self._m_step2`` advances
``self._m_step2_iters`` exact iterations in one call (the fused TV K-step
kernel).  A block then runs ``stop_rate // k`` multi-steps followed by
``stop_rate % k`` single steps.

Modes: ``Mode.BLOCK`` runs to the end and returns; ``Mode.MANUAL`` returns
a generator of states, one iteration each (``steps``); ``Mode.ASYNC`` runs
the BLOCK loop on a worker thread (``busy``, ``stop``, ``solution``).

Spans (:func:`~pyxu_tpu_torch.utils.profiler.span`): ``solver.fit`` (each
fit, each phase of a ``precision_schedule``), ``solver.init`` (``m_init``,
or ``_m_refresh`` where a fit skips it, with the fit's set-up),
``solver.block`` (a block; in MANUAL mode an iteration), ``solver.check``
(the criterion and the history row) and ``solver.host_read`` (the stop
flag's read: the host's wait on the device).

Also ported: ``warm_start``, ``update_operands``, ``precision_schedule``,
``track_objective``, logging (``verbosity``, ``show_progress``), and
checkpoints (``writeback``, ``read_checkpoint``) under the ``npz`` backend,
which writes the JAX package's ``data.npz`` layout, and the ``torch``
backend, which writes the whole math state with ``torch.save``.
"""

from __future__ import annotations

import enum
import logging
import pathlib
import tempfile
import threading
import traceback

import numpy as np
import torch

from pyxu_tpu_torch.opt.stop import (
    MaxIter,
    RelError,
    StoppingCriterion,
    _host_array,
)
from pyxu_tpu_torch.runtime import host_read
from pyxu_tpu_torch.utils.profiler import span, spanned

__all__ = ["Mode", "Solver", "StoppingCriterion"]


class Mode(enum.Enum):
    BLOCK = enum.auto()
    MANUAL = enum.auto()
    ASYNC = enum.auto()


def _to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    d = getattr(torch, name, None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return d


def _cast_state(mstate: dict, dtype) -> dict:
    """Every non-scalar floating tensor of the state in ``dtype``; 0-d
    entries are counters and flags and stay as they are (PGD's ``k`` and
    ProxAdam's ``t`` are float32 on purpose: bf16 would freeze them)."""
    return {k: v.to(dtype) if (isinstance(v, torch.Tensor) and v.ndim > 0
                               and v.is_floating_point()) else v
            for k, v in mstate.items()}


def _dtype_locked(step):
    """``step`` with each output tensor cast back to its input's dtype: a
    ``precision_schedule`` phase keeps the iterate at the phase's dtype
    where operator data (f32 taps, a cached f32 gradient) would promote
    it."""
    def locked(s):
        out = step(s)
        return {k: v.to(s[k].dtype) if (isinstance(v, torch.Tensor)
                                        and isinstance(s.get(k), torch.Tensor))
                else v for k, v in out.items()}
    return locked


class _History:
    """One row per block: device columns for tensor metrics, host columns
    for numbers the host already knows (the iteration, ``N_iter``).  The
    columns come in sorted order, as the JAX package's do (its metric dict
    goes through a pytree)."""

    def __init__(self, n_rec: int):
        self.n_rec = n_rec
        self.n = 0
        self.names: list = []
        self.dev: dict = {}
        self.host: dict = {}

    def record(self, row: dict):
        if self.n >= self.n_rec:
            return
        if not self.names:
            self.names = sorted(row)
            for name, v in row.items():
                if isinstance(v, torch.Tensor):
                    self.dev[name] = torch.zeros(self.n_rec, dtype=v.dtype,
                                                 device=v.device)
                else:
                    self.host[name] = np.zeros(self.n_rec,
                                               np.asarray(v).dtype)
        for name, v in row.items():
            (self.dev if name in self.dev else self.host)[name][self.n] = v
        self.n += 1

    def last_row(self) -> dict:
        """The last row's values as floats (a read of each device column)."""
        if not self.n:
            return {}
        return {name: float((self.dev if name in self.dev else self.host)
                            [name][self.n - 1]) for name in self.names}

    def assemble(self, host_records=()):
        """The structured array of the first ``n`` rows (the device
        columns read back), host-metric columns NaN outside the rows that
        recorded them."""
        n = self.n
        if not self.names:
            return None
        arrays = {}
        for name in self.names:
            arrays[name] = _host_array(self.dev[name][:n]) \
                if name in self.dev else self.host[name][:n]
        host_cols = {}
        for idx, hm in host_records:
            for hname, hval in hm.items():
                col = host_cols.setdefault(
                    hname, np.full(n, np.nan, np.float64))
                if 0 <= idx < n:
                    col[idx] = float(hval)
        arrays.update(host_cols)
        names = self.names + [h for h in host_cols if h not in self.names]
        out = np.empty(n, dtype=[(nm, arrays[nm].dtype) for nm in names])
        for nm in names:
            out[nm] = arrays[nm]
        return out


class Solver:
    """Iterative solver skeleton."""

    def __init__(self, *, log_var=("x",), verbosity: int = None,
                 show_progress: bool = False, folder=None,
                 exist_ok: bool = False, stop_rate: int = 1,
                 writeback_rate: int = None, checkpoint_backend: str = "npz",
                 operand_mode: str = "static"):
        if checkpoint_backend == "orbax":
            raise ValueError(
                'checkpoint_backend="orbax" has no counterpart in the PyTorch '
                'port: use "torch" (the whole math state through torch.save) '
                'or "npz"')
        assert checkpoint_backend in ("npz", "torch"), checkpoint_backend
        # kept for the JAX package's signature: with no compiled program
        # there is nothing to bake operands into
        assert operand_mode in ("static", "dynamic"), operand_mode
        if int(stop_rate) <= 0:
            raise ValueError(f"stop_rate must be positive, got {stop_rate}")
        self._ckpt_backend = checkpoint_backend
        self._log_var = tuple(log_var)
        self._verbosity = verbosity
        self._show_progress = bool(show_progress)
        self._stop_rate = int(stop_rate)
        self._writeback_rate = writeback_rate
        self._folder = folder
        self._exist_ok = exist_ok
        self._mstate: dict = {}
        self._history = None
        self._history_pending = None
        self._dtype_lock = False
        self._fit_error = None
        self._m_step2 = None
        self._m_step2_iters = 0
        self._astate = {
            "active": None, "worker": None, "mode": None, "logger": None,
            "stop_crit": None, "wb_dir": None,
        }

    # ------------------------------------------------------------ subclass --
    def m_init(self, **kwargs) -> dict:
        raise NotImplementedError

    def m_step(self, mstate: dict) -> dict:
        raise NotImplementedError

    def default_stop_crit(self) -> StoppingCriterion:
        return RelError(eps=1e-4, var="x")

    def objective_func(self, mstate: dict):
        raise NotImplementedError

    def _m_refresh(self, mstate: dict) -> None:
        """Re-derive from ``mstate`` what ``m_init`` decided (default:
        nothing)."""

    # ----------------------------------------------------------------- fit --
    @spanned("solver.fit")
    def fit(self, *, mode: Mode = Mode.BLOCK,
            stop_crit: StoppingCriterion = None, max_iter: int = 10_000,
            segment_size: int = None, track_objective: bool = False,
            warm_start: bool = False, precision_schedule=None,
            **m_init_kwargs):
        """Solve.  ``max_iter`` is a hard cap (it sizes the history);
        ``segment_size`` = iterations between the host's segment-end work
        (default: the writeback or verbosity cadence, else the whole
        solve; at most ``max(stop_rate, 50)`` under a criterion with a host
        part).

        ``warm_start=True`` continues from the previous fit's math state
        (``m_init`` is skipped; step sizes persist).  With
        :meth:`update_operands` it re-solves against new data.

        ``precision_schedule``: a list of ``(dtype, n_iters)`` phases.  The
        floating tensors of the math state are cast to each phase's dtype
        once, and the solve warm-starts through the phases; the last phase
        may take ``n_iters=None`` to run under ``stop_crit`` with the rest
        of the ``max_iter`` budget, e.g. ``precision_schedule=
        [(torch.bfloat16, 700), (torch.float32, None)]``.  BLOCK mode only.
        A segment that raises keeps the last good state and logs the error;
        within a schedule the error then ends the fit (a kernel that
        refuses the phase's dtype, say).
        """
        if precision_schedule is not None:
            return self._fit_scheduled(
                precision_schedule, mode=mode, stop_crit=stop_crit,
                max_iter=max_iter, segment_size=segment_size,
                track_objective=track_objective, warm_start=warm_start,
                m_init_kwargs=m_init_kwargs)
        self._astate["mode"] = mode
        # stale ASYNC state (a cleared Event from a stop()) must not truncate
        # a later BLOCK/MANUAL fit
        self._astate["active"] = None
        self._astate["worker"] = None
        with span("solver.init"):
            self._fit_init(stop_crit, max_iter, segment_size,
                           track_objective)
            if warm_start:
                assert self._mstate, "warm_start=True requires a previous fit"
                assert not m_init_kwargs, \
                    "warm_start=True skips m_init; m_init kwargs have no effect"
                self._m_refresh(self._mstate)
            else:
                self._mstate = self.m_init(**m_init_kwargs)
        if mode is Mode.BLOCK:
            self._fit_run()
            return self
        if mode is Mode.MANUAL:
            return self.steps()
        if mode is Mode.ASYNC:
            w = threading.Thread(target=self._fit_run, daemon=True)
            self._astate["worker"] = w
            self._astate["active"] = threading.Event()
            self._astate["active"].set()
            w.start()
            return self
        raise ValueError(mode)

    def _fit_scheduled(self, schedule, *, mode, stop_crit, max_iter,
                       segment_size, track_objective, warm_start,
                       m_init_kwargs):
        """Run the phases of a ``precision_schedule`` (see :meth:`fit`).
        ``phase_log`` records each phase's dtype, iterations and, where the
        solver has one, its ``fused_path``."""
        if mode is not Mode.BLOCK:
            raise ValueError("precision_schedule supports BLOCK mode only")
        phases = [(_to_dtype(d), n) for d, n in schedule]
        if not phases:
            raise ValueError("precision_schedule must be non-empty")
        for _, n in phases[:-1]:
            if not (isinstance(n, int) and n > 0):
                raise ValueError(
                    "every phase but the last needs a positive iteration "
                    f"count, got {n!r}")
        if phases[-1][1] is not None and not (
                isinstance(phases[-1][1], int) and phases[-1][1] > 0):
            raise ValueError("last phase n_iters must be a positive int or "
                             "None (= run under the stop criterion)")
        fixed = sum(n for _, n in phases if n is not None)
        if fixed > int(max_iter):
            raise ValueError(
                f"precision_schedule phases request {fixed} iterations but "
                f"max_iter={max_iter} is a hard cap")
        if warm_start:
            assert self._mstate, "warm_start=True requires a previous fit"
        else:
            with span("solver.init"):
                self._mstate = self.m_init(**m_init_kwargs)
        self.phase_log = []
        used = 0
        self._dtype_lock = True
        try:
            for i, (dtype, n) in enumerate(phases):
                last = i == len(phases) - 1
                if last and n is None:
                    budget = int(max_iter) - used
                    if budget <= 0:     # fixed phases consumed the cap
                        break
                else:
                    budget = int(n)
                self._mstate = _cast_state(self._mstate, dtype)
                crit = stop_crit if (last and n is None) else MaxIter(budget)
                self.fit(mode=Mode.BLOCK, stop_crit=crit, max_iter=budget,
                         segment_size=segment_size,
                         track_objective=track_objective, warm_start=True)
                if self._fit_error is not None:
                    # a phase cut short by a raising segment (a kernel that
                    # refuses the phase's dtype) is not the schedule asked
                    # for: the last good state stays, the error goes up
                    raise self._fit_error
                self.phase_log.append({
                    "dtype": str(dtype).replace("torch.", ""),
                    "iterations": self._last_k,
                    "fused_path": getattr(self, "fused_path", None)})
                used += budget
        finally:
            self._dtype_lock = False
        return self

    def _fit_init(self, stop_crit, max_iter, segment_size, track_objective):
        stop = stop_crit if stop_crit is not None else self.default_stop_crit()
        self._astate["stop_crit"] = stop
        self._max_iter = int(max_iter)
        self._track_objective = bool(track_objective)
        cadence = [s for s in (self._writeback_rate, self._verbosity) if s]
        self._segment = int(segment_size or (min(cadence) if cadence
                                             else self._max_iter))
        if segment_size is None and stop.has_host_part():
            # wall-clock and carbon budgets fire only between segments: a
            # whole-solve segment would never consult them
            self._segment = min(self._segment, max(self._stop_rate, 50))
        if self._folder is not None:
            wb = pathlib.Path(self._folder).expanduser().resolve()
            wb.mkdir(parents=True, exist_ok=self._exist_ok)
        elif self._writeback_rate is not None:
            # one temporary directory per solver, not per fit
            wb = getattr(self, "_auto_wb_dir", None)
            if wb is None:
                wb = pathlib.Path(tempfile.mkdtemp(prefix="pyxu_tpu_torch_"))
                self._auto_wb_dir = wb
        else:
            wb = None
        self._astate["wb_dir"] = wb
        # a re-fit with a new folder gets its own solver.log
        logger = logging.getLogger(
            f"pyxu_tpu_torch.{type(self).__name__}.{id(self):x}."
            f"{wb or 'nolog'}")
        logger.setLevel(logging.DEBUG)
        prev = self._astate.get("logger")
        if prev is not None and prev is not logger:
            for h in list(prev.handlers):   # close the old fit's handlers
                h.close()
                prev.removeHandler(h)
        if wb is not None and not logger.handlers:
            fh = logging.FileHandler(wb / "solver.log")
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
        if self._show_progress and not any(
                isinstance(h, logging.StreamHandler)
                and not isinstance(h, logging.FileHandler)
                for h in logger.handlers):
            logger.addHandler(logging.StreamHandler())
        self._astate["logger"] = logger

    # ------------------------------------------------------------ operands --
    def update_operands(self, **ops):
        """Swap operator attributes, e.g. ``slv.update_operands(f=new_loss)``
        after new data arrives; the next fit (cold, or ``warm_start``) runs
        on them."""
        from pyxu_tpu_torch.abc.operator import Operator
        for name, new in ops.items():
            attr = name if name in self.__dict__ else f"_{name}"
            old = self.__dict__.get(attr)
            assert isinstance(old, Operator), \
                f"{type(self).__name__} has no operator operand {name!r}"
            assert isinstance(new, Operator), new
            self.__dict__[attr] = new

    # ----------------------------------------------------------- BLOCK loop --
    def _block_steps(self):
        """(one block's step function, the block's multi-step count and
        single-step count)."""
        step, step2 = self.m_step, self._m_step2
        if self._dtype_lock:
            step = _dtype_locked(step)
            if step2 is not None:
                step2 = _dtype_locked(step2)
        kk = int(self._m_step2_iters or 0)
        rate = self._stop_rate
        n2, n1 = (rate // kk, rate % kk) if step2 is not None and rate >= kk \
            else (0, rate)

        def block(mstate):
            for _ in range(n2):
                mstate = step2(mstate)
            for _ in range(n1):
                mstate = step(mstate)
            return mstate
        return block

    def _check(self, stop, cstate, mstate, k):
        cstate, stop_now, metrics = stop.update(cstate, mstate, k)
        row = {"iteration": np.int32(k), **metrics}
        if self._track_objective:
            obj = torch.as_tensor(self.objective_func(mstate))
            row["objective"] = (obj if obj.ndim == 0
                                else torch.max(obj)).to(torch.float32)
        return cstate, stop_now, row

    @torch.no_grad()
    def _fit_run(self):
        stop = self._astate["stop_crit"]
        logger = self._astate["logger"]
        stop.host_init()
        cstate = stop.init_state(self._mstate)
        hist = _History(self._max_iter // self._stop_rate + 2)
        host_records = []   # (history row, host metrics) per segment
        block = self._block_steps()
        mstate, k = self._mstate, 0
        self._fit_error = None
        while True:
            k_end = min(k + self._segment, self._max_iter)
            good = (mstate, cstate, k, hist.n)
            try:
                stopped = False
                while not stopped and k < k_end:
                    with span("solver.block"):
                        mstate = block(mstate)
                    k += self._stop_rate
                    with span("solver.check"):
                        cstate, stop_now, row = self._check(stop, cstate,
                                                            mstate, k)
                        hist.record(row)
                    with span("solver.host_read"):
                        stopped = host_read(stop_now)
            except Exception as exc:
                # the last good state (the segment's start) survives
                mstate, cstate, k, hist.n = good
                self._fit_error = exc
                if logger is not None:
                    logger.error("solver segment raised; stopping fit:\n%s",
                                 traceback.format_exc())
                break
            self._mstate = mstate
            if logger is not None and (self._verbosity or self._show_progress):
                msg = ", ".join(f"{name}={v:.4e}" for name, v in
                                hist.last_row().items() if name != "iteration")
                logger.info("[%d] %s", k, msg)
            if self._writeback_rate is not None:
                self._history, self._history_pending = None, (
                    hist, list(host_records))
                self.writeback()
            # latch host-side firing into the carry so that composed
            # criteria (& / |) see it in the next segment
            cstate = stop.refresh_host(cstate)
            hm = stop.host_metrics()
            if hm:
                host_records.append((max(hist.n - 1, 0), hm))
            if stopped or stop.host_check() or k >= self._max_iter:
                break
            active = self._astate["active"]
            if active is not None and not active.is_set():
                break
        self._mstate = mstate
        self._last_k = k
        # the history is read back lazily, at stats() or writeback()
        self._history = None
        self._history_pending = (hist, host_records)
        if self._astate["wb_dir"] is not None:
            try:
                self.writeback()
            except Exception:
                if logger is not None:
                    logger.error("history/writeback failed:\n%s",
                                 traceback.format_exc())

    def _ensure_history(self):
        pending = self._history_pending
        if self._history is None and pending is not None:
            self._history = pending[0].assemble(pending[1])
            self._history_pending = None
        return self._history

    # -------------------------------------------------------- MANUAL mode --
    def steps(self, n: int = None):
        """Generator of math states, one iteration at a time."""
        stop = self._astate["stop_crit"]
        stop.host_init()
        cstate = stop.init_state(self._mstate)
        k = 0
        records = []
        while (n is None or k < n) and k < self._max_iter:
            with torch.no_grad():
                with span("solver.block"):
                    self._mstate = self.m_step(self._mstate)
                with span("solver.check"):
                    cstate, stop_now, metrics = stop.update(
                        cstate, self._mstate, k + 1)
            k += 1
            records.append({"iteration": np.int32(k),
                            **{m: _host_array(v)[()] for m, v in
                               metrics.items()}})
            yield self._mstate
            with span("solver.host_read"):
                stopped = host_read(stop_now)
            if stopped or stop.host_check():
                break
        self._history = _records_to_struct(records)
        self._history_pending = None

    # --------------------------------------------------------- ASYNC mode --
    def busy(self) -> bool:
        w = self._astate["worker"]
        return w is not None and w.is_alive()

    def stop(self):
        """Interrupt an ASYNC fit at its next segment's end and wait for
        the worker."""
        if self._astate["active"] is not None:
            self._astate["active"].clear()
        w = self._astate["worker"]
        if w is not None:
            w.join()

    # ------------------------------------------------------------- results --
    def solution(self):
        return self._mstate.get("x")

    def stats(self):
        """(math-state dict, history structured array), one row per
        block."""
        return self._mstate, self._ensure_history()

    def writeback(self):
        """Checkpoint the state and the history into the workdir.

        ``checkpoint_backend="npz"``: the ``log_var`` entries (all of them
        when ``log_var`` is empty) as ``mstate_<name>`` and the history, in
        ``data.npz`` (bfloat16 tensors are widened to float32: numpy has
        no bfloat16).  ``"torch"``: the whole math state through
        ``torch.save`` in ``ckpt.pt`` (read back onto the device it was
        saved from) and the history in ``history.npz``.
        """
        wb = self._astate["wb_dir"]
        if wb is None:
            return
        hist = self._ensure_history()
        if self._ckpt_backend == "torch":
            torch.save(self._mstate, pathlib.Path(wb) / "ckpt.pt")
            if hist is not None:
                np.savez(pathlib.Path(wb) / "history.npz", history=hist)
            return
        data = {f"mstate_{k}": _host_array(v) for k, v in self._mstate.items()
                if k in self._log_var or not self._log_var}
        if hist is not None:
            data["history"] = hist
        np.savez(pathlib.Path(wb) / "data.npz", **data)

    @property
    def workdir(self):
        return self._astate["wb_dir"]

    @property
    def logfile(self):
        """Path of the fit's log file; None without a workdir."""
        wd = self.workdir
        return None if wd is None else pathlib.Path(wd) / "solver.log"

    @property
    def datafile(self):
        """Path of the checkpoint :meth:`writeback` writes: ``data.npz``,
        or ``ckpt.pt`` under the torch backend."""
        wd = self.workdir
        if wd is None:
            return None
        return pathlib.Path(wd) / ("ckpt.pt" if self._ckpt_backend == "torch"
                                   else "data.npz")

    @staticmethod
    def read_checkpoint(folder):
        """Load a :meth:`writeback` checkpoint: (math-state dict, history).

        A ``ckpt.pt`` (torch backend) comes back as tensors on the device it
        was saved from; a ``data.npz`` (this port's or the JAX package's) as
        numpy arrays.  ``fit(x0=mstate["x"], ...)`` resumes from it.
        """
        folder = pathlib.Path(folder)
        if (folder / "ckpt.pt").exists():
            mstate = torch.load(folder / "ckpt.pt")
            history = None
            if (folder / "history.npz").exists():
                history = np.load(folder / "history.npz")["history"]
            return mstate, history
        if (folder / "ckpt").exists():
            raise ValueError(
                f"{folder / 'ckpt'} is an orbax checkpoint, which the PyTorch "
                'port cannot read: write it with checkpoint_backend="torch" '
                'or "npz"')
        data = np.load(folder / "data.npz")
        mstate = {k[len("mstate_"):]: data[k] for k in data.files
                  if k.startswith("mstate_")}
        history = data["history"] if "history" in data.files else None
        return mstate, history


def _records_to_struct(records):
    if not records:
        return None
    names = list(records[0].keys())
    dtypes = [(n, np.asarray(records[0][n]).dtype) for n in names]
    out = np.empty(len(records), dtype=dtypes)
    for i, r in enumerate(records):
        for n in names:
            out[i][n] = r[n]
    return out
