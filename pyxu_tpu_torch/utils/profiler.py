"""Profiling helpers (counterpart of ``pyxu_tpu/utils/profiler.py``).

Thin conveniences over ``torch.profiler`` and the host clock, so that a
solver run can be traced or timed without boilerplate, and :func:`span`,
the one way the port marks its own host work: the solver engine's fit,
init, blocks, checks and stop-flag reads, the step sizes and the fusion
match, the operands a primal-dual iteration calls, the operator algebra,
the kernel wrappers' launches and the NUFFT's set-up parts.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "timed", "span", "spanned"]

# The span hook: None, or a callable(name) returning a context manager,
# which every span then opens in place of a profiler range (a set-up timer
# that synchronises and times each part, say).
SPAN = None

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the named part of the port's host work.

    Under a recording ``torch.profiler`` it is the range ``pyxu.<name>``,
    in the trace beside the device's events and on their clock, nested in
    the range that encloses it on its thread; where :data:`SPAN` is set,
    ``SPAN(name)``; otherwise one shared no-op context, for the cost of two
    flag tests.  The profiler's flag is the process's, so a worker
    thread's spans (an ASYNC fit) are ranges too, recorded where the
    profiler records every thread (:func:`trace`).

    The range is the profiler's fast one (``_RecordFunctionFast``, about
    1 µs a range on an H100 host against 9-14 µs for ``record_function``):
    the generic Condat-Vu iteration opens eleven, and its host barely keeps
    ahead of the card."""
    if SPAN is not None:
        return SPAN(name)
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast("pyxu." + name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs in ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA where a card is present; every
    thread's ranges, an ASYNC fit's worker too) and write a Chrome/Perfetto
    trace, ``<logdir>/trace.json``:

    >>> with trace("run-trace"):
    ...     solver.fit(...)
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    prof = torch.profiler.profile(activities=acts,
                                  experimental_config=every_thread)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(v):
    """Wait for the devices of the tensors in ``v`` (a tensor, or a list,
    tuple or dict of them)."""
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
    elif isinstance(v, dict):
        for u in v.values():
            _synchronize(u)
    elif isinstance(v, (list, tuple)):
        for u in v:
            _synchronize(u)


@contextlib.contextmanager
def timed(label: str = "", sync=None):
    """Wall-clock a block.  Store device results in the yielded dict
    (``with timed("fit") as out: out["x"] = slv.solution()``): the devices
    of those tensors, and of ``sync``, are synchronized before the clock
    stops, so queued kernels are counted.  ``out["seconds"]`` holds the
    time."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        _synchronize(sync)
        _synchronize(list(out.values()))
        out["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[{label}] {out['seconds']:.4f}s")
