"""The program's own ranges in a traced window, for the per-layer metrics
that put the card's idle down to the port's host work.

The port opens a profiler range ``pyxu.<name>`` at each layer boundary
while a profiler records (``pyxu_tpu_torch/utils/profiler.py`` ``span``):
the solver engine (``pyxu.solver.fit``, ``.init``, ``.block``,
``.check``, ``.host_read``), the step sizes and the fusion match, the
operands of an iteration (``pyxu.op.*``), the operator algebra and the
kernel wrappers (``pyxu.kernel.*``).  ``trace_reader.reduce_trace`` keeps
the benchmark's ``bench.<part>`` ranges and the device's events; this
module reads the same raw events for what it leaves out:

* ``program``: the ``pyxu.*`` CPU ranges, ``(name, start ns, end ns,
  thread)``;
* ``launches``: each device event (as ``reduce_trace`` counts them) as
  ``(launch ns, start ns, end ns)``, the launch its runtime call's start,
  else the event's own start;
* ``syncs``: the host's calls that wait on the device, ``(name, start ns,
  end ns, thread)``: ``SYNCS`` by the runtime's names (stream, device and
  event synchronises, the synchronous ``cudaMemcpy``, ``cudaFree``);
* ``idle_by_span``: the device-idle ns of the window (the complement of
  ``reduce_trace``'s ``busy`` in its window) split over the innermost range
  the host was in during each part of each idle interval, by overlap: the
  ``pyxu.*`` range that started last among those open, else the
  ``bench.<part>``, else ``between solves``.

A run whose program opens no ``pyxu.*`` range (one older than the spans)
gives empty ``program`` and ``idle_by_span`` holds only the benchmark's
parts; the metrics that read the program's ranges then return None.
"""

from __future__ import annotations

import bisect
import heapq
import sys

import harness

PROGRAM = "pyxu."
BENCH = "bench."
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaFree"})


def _profile():
    """The profiler of the traced window, from the stack of the caller
    that reads the metrics: the harness hands them ``reduce_trace``'s
    reduction, which keeps no host range of the program's."""
    import torch
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def _events(prof):
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler holds no kineto results")
    return res.events()


def _window(tr):
    """The traced window ``(lo, hi)`` in ns: ``reduce_trace``'s."""
    return tr["spans"][0][1], max(s[2] for s in tr["spans"])


def _gaps(tr):
    """The window's idle intervals: the complement of ``busy`` in it."""
    lo, hi = _window(tr)
    out, prev = [], lo
    for s, e in list(tr["busy"]) + [(hi, hi)]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def _timeline(program, spans):
    """``[(start, end, label)]``, disjoint and sorted: the innermost range
    the host was in, a ``pyxu.*`` one before a ``bench.*`` one."""
    marks = []
    for i, (name, s, e, _) in enumerate(program):
        marks.append((s, 1, i, 1, name))
        marks.append((e, 0, i, 1, name))
    for i, (part, s, e) in enumerate(spans):
        marks.append((s, 1, i, 0, BENCH + part))
        marks.append((e, 0, i, 0, BENCH + part))
    marks.sort(key=lambda m: (m[0], m[1]))
    heap, gone, out = [], set(), []
    prev = None
    for t, opening, i, rank, name in marks:
        while heap and (heap[0][2], heap[0][3]) in gone:
            heapq.heappop(heap)
        if prev is not None and t > prev:
            label = heap[0][4] if heap else "between solves"
            if out and out[-1][2] == label and out[-1][1] == prev:
                out[-1] = (out[-1][0], t, label)
            else:
                out.append((prev, t, label))
        prev = t
        if opening:
            heapq.heappush(heap, (-rank, -t, rank, i, name))
        else:
            gone.add((rank, i))
    return out


def idle_by_span(gaps, timeline) -> dict:
    """Idle ns of ``gaps`` by the timeline's label over each part."""
    out: dict = {}
    k = 0
    for a, b in gaps:
        while k < len(timeline) and timeline[k][1] <= a:
            k += 1
        j, t = k, a
        while t < b:
            if j < len(timeline) and timeline[j][0] <= t:
                end = min(b, timeline[j][1])
                label = timeline[j][2]
                j += 1
            else:
                end = min(b, timeline[j][0]) if j < len(timeline) else b
                label = "between solves"
            out[label] = out.get(label, 0) + (end - t)
            t = end
    return out


def reduce_program(prof, tr, top: int = 10, log=None) -> dict:
    """``program``, ``launches``, ``syncs`` and ``idle_by_span`` (ns by
    label) of the traced window whose ``reduce_trace`` reduction is
    ``tr``; ``log`` (a callable) is given the ``top`` labels by idle."""
    from torch.autograd import DeviceType
    program, syncs, raw, launched = [], [], [], {}
    for ev in _events(prof):
        name = ev.name()
        dt = ev.device_type()
        if dt == DeviceType.CPU:
            if name.startswith(PROGRAM):
                program.append((name, ev.start_ns(), ev.end_ns(),
                                ev.start_thread_id()))
            elif name.startswith("cu"):
                if name in SYNCS:
                    syncs.append((name, ev.start_ns(), ev.end_ns(),
                                  ev.start_thread_id()))
                if ev.correlation_id():
                    launched[ev.correlation_id()] = ev.start_ns()
        elif dt == DeviceType.CUDA and not name.startswith((BENCH, PROGRAM)) \
                and not ev.is_user_annotation():
            raw.append((ev.correlation_id(), ev.start_ns(), ev.end_ns()))
    program.sort(key=lambda r: r[1])
    syncs.sort(key=lambda r: r[1])
    launches = sorted((launched.get(cid, s) if cid else s, s, e)
                      for cid, s, e in raw)
    idle = idle_by_span(_gaps(tr), _timeline(program, tr["spans"]))
    if log is not None:
        best = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        log("[trace] idle by program span: " + ", ".join(
            f"{n} {t * 1e-9:.4f} s" for n, t in best))
    return dict(program=program, launches=launches, syncs=syncs,
                idle_by_span=idle)


def of(ctx):
    """The reduction of the run's traced window (made once a run, kept in
    ``ctx``), or None where nothing was traced on the card.  The profiler
    is ``ctx["profile"]`` where the caller gives it, else found on the
    stack."""
    if ctx.get("trace") is None:
        return None
    if "program" not in ctx:
        prof = ctx.get("profile")
        if prof is None:
            prof = _profile()
        ctx["program"] = None if prof is None else reduce_program(
            prof, ctx["trace"],
            log=lambda s: print(s, file=sys.stderr, flush=True))
    return ctx["program"]


def ranges(ctx, name: str):
    """Merged intervals of the program's ranges called ``name`` inside the
    traced window (nested ranges of one name count once), or None where
    the run traced none."""
    pr = of(ctx)
    if pr is None:
        return None
    lo, hi = _window(ctx["trace"])
    union = harness.load_here("trace_reader").union
    ivs = union((max(s, lo), min(e, hi)) for n, s, e, _ in pr["program"]
                if n == name and e > lo and s < hi)
    return ivs or None


def total(intervals) -> int:
    return sum(e - s for s, e in intervals)


def count_in(intervals, times) -> int:
    """How many of the sorted ``times`` lie inside the merged, sorted
    ``intervals``."""
    return sum(bisect.bisect_right(times, e) - bisect.bisect_left(times, s)
               for s, e in intervals)


def per_iteration(ctx, count):
    """``count`` over the window's iterations (None without any)."""
    n = ctx["solves"] * ctx["iterations"]
    return count / n if n else None
