"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics and the breakdown read.

Read from the profiler's raw events (no post-processing by the profiler,
which may stop early on a long trace):

* the benchmark's spans: the CPU ``record_function`` ranges named
  ``bench.<part>``;
* the device's activity: every CUDA event that is not such a range's
  device-side copy (kernels, copies, sets);
* the host's launches: the CUDA API calls (``cuda*``, ``cu*``), whose
  correlation id a device event carries.

Each device event is put down to the span whose host range holds its
launch, wherever on the device's clock it ran: the spans end in no
synchronise, so the traced loop is the loop that the untraced run times.
An event whose launch the trace lacks is put down by its own start.  The
traced window runs from the first span's start to the last one's end.
"""

from __future__ import annotations

import bisect

PREFIX = "bench."


def _events(prof):
    inner = getattr(prof, "profiler", None)
    res = getattr(inner, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler holds no kineto results")
    return res.events()


def union(intervals):
    """Merged, sorted ``[(start, end)]`` of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _part_at(spans, starts, t) -> str:
    """The part whose span holds host time ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    return spans[k][0] if k >= 0 and spans[k][2] > t else "between solves"


def reduce_trace(prof, top: int = 10) -> dict:
    """``spans`` [(part, start ns, end ns)], ``device`` [(name, start,
    end, part)], ``busy`` (merged device intervals inside the window),
    ``part_busy`` ({part: merged intervals of its events}), ``unlinked``
    (device events with no launch in the trace), and the window's
    ``busy_s``, ``window_s``, ``device_ops`` (the ``top`` names by device
    seconds) and ``idle_gaps`` (idle device seconds by the part the host
    was in, the ``top`` largest)."""
    from torch.autograd import DeviceType
    spans, raw, launched = [], [], {}
    for ev in _events(prof):
        name = ev.name()
        dt = ev.device_type()
        if dt == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], ev.start_ns(),
                              ev.end_ns()))
            elif name.startswith("cu") and ev.correlation_id():
                launched[ev.correlation_id()] = ev.start_ns()
        elif dt == DeviceType.CUDA and not name.startswith(PREFIX) \
                and not ev.is_user_annotation():
            raw.append((name, ev.start_ns(), ev.end_ns(),
                        ev.correlation_id()))
    spans.sort(key=lambda s: s[1])
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    starts = [s[1] for s in spans]
    lo, hi = spans[0][1], max(s[2] for s in spans)
    device, unlinked = [], 0
    for name, s, e, cid in raw:
        t = launched.get(cid) if cid else None
        if t is None:
            unlinked += 1
            t = s
        device.append((name, s, e, _part_at(spans, starts, t)))

    def inside(events):
        return union((max(s, lo), min(e, hi)) for _, s, e, _ in events
                     if e > lo and s < hi)

    merged = inside(device)
    busy = sum(e - s for s, e in merged)
    part_busy = {p: inside([d for d in device if d[3] == p])
                 for p in {d[3] for d in device}}
    by_name: dict = {}
    for name, s, e, _ in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps, each put down to the part the host was in at its start
    gaps: dict = {}
    prev = lo
    for s, e in merged + [(hi, hi)]:
        if s > prev:
            part = _part_at(spans, starts, prev)
            gaps[part] = gaps.get(part, 0) + (s - prev)
        prev = max(prev, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return dict(spans=spans, device=device, busy=merged,
                part_busy=part_busy, unlinked=unlinked,
                busy_s=busy * 1e-9, window_s=(hi - lo) * 1e-9,
                device_ops=[[n, t * 1e-9] for n, t in ops],
                idle_gaps=[[n, t * 1e-9] for n, t in idle])


def part_device_ns(tr: dict, part: str) -> int:
    """Device-busy ns of the events launched inside the spans of
    ``part``."""
    return sum(e - s for s, e in tr["part_busy"].get(part, ()))


def kernel_ns(tr: dict, match) -> int:
    """Device ns of the events whose name ``match`` accepts (0: none)."""
    return sum(e - s for n, s, e, _ in tr["device"] if match(n))
