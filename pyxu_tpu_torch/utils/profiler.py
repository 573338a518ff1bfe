"""Profiling helpers (counterpart of ``pyxu_tpu/utils/profiler.py``).

Thin conveniences over ``torch.profiler`` and the host clock, so that a
solver run can be traced or timed without boilerplate.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    a Chrome/Perfetto trace, ``<logdir>/trace.json``:

    >>> with trace("run-trace"):
    ...     solver.fit(...)
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
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
