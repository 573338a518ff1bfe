"""The benchmark's harness: one cell of ``BENCHMARK.json``, one run.

A run is one client sending solves in a closed loop.  A solve is one
frame's reconstruction as a user's pipeline makes it: a host tensor of
data (page-locked, as a capture or streaming pipeline holds its frames)
goes to the device, the data term and the solver are built through the
port's public API on operators built once in set-up, ``fit`` runs the
cell's fixed iteration count, and the solution comes back into a host
buffer.  The next frame is sent when the solution is back.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
  ``configs/<config>.py``: ``build(cfg, traffic, shared, device)``, the
  port's operators and the solve;
* ``traffic/<traffic>.json``: the mix's parameters (iterations, frame
  pool, the constraint, the sample the reference checks);
* ``reference/<config>.py``: ``make_inputs`` (the frames and what they
  share, from the seed) and ``Reference`` (the plain solve), neither of
  which imports the port;
* ``limits/<workload>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: ``read(ctx)``, a per-layer metric or None;
* ``work/<kernel>.py``: ``work(cfg, traffic)``, the bytes and operations
  a kernel's share of the problem needs.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import random
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names a run may not hold once its window has closed
BLOCKED = ("jax", "jaxlib", "flax", "pyxu_tpu")
GiB = 2.0 ** 30


def spec(path=None) -> dict:
    """``BENCHMARK.json`` (at the checkout's root by default)."""
    path = REPO / "BENCHMARK.json" if path is None else pathlib.Path(path)
    return json.loads(path.read_text())


def read_json(kind: str, name: str, root=None) -> dict:
    return json.loads(((root or ROOT) / kind / f"{name}.json").read_text())


def _module(path: pathlib.Path, key: str):
    """The module at ``path``, held in ``sys.modules`` under ``key``."""
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    sp = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[key] = mod
    sp.loader.exec_module(mod)
    return mod


def load(kind: str, name: str, root=None):
    """The module ``<root>/<kind>/<name>.py`` (names may hold dots)."""
    path = (root or ROOT) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    key = f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    return _module(path, key)


def load_here(name: str):
    """The module ``perfbench/<name>.py``."""
    return _module(ROOT / f"{name}.py", f"perfbench_{name}")


def cell(bench: dict, workload: str) -> dict:
    """The workload's entry with its configuration entry, its end-to-end
    metrics and its per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(workload=w, config=conf,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def blocked_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is a blocked one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in BLOCKED)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between closest ranks."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    return float(statistics.quantiles(v, n=100, method="inclusive")[q - 1])


class Spans:
    """Host ms of each named part of each solve.  Traced, each part is
    also a ``record_function`` range, and nothing more: the loop runs as
    it does untraced, and the trace puts each device operation down to
    the range that launched it (``trace_reader``)."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.solves: list = []       # one {part: host ms} a solve

    def new_solve(self):
        self.solves.append({})

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            import torch
            rf = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        ms = 1e3 * (time.perf_counter() - t0)
        cur = self.solves[-1] if self.solves else {}
        cur[name] = cur.get(name, 0.0) + ms


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, bench=None,
             root=None, cfg_override: dict = None,
             traffic_override: dict = None, log=None,
             control=None) -> dict:
    """Run one cell once; returns the result object (the last line a run
    prints).  ``device="cpu"`` is for the CPU tests (no device metrics);
    the overrides shrink the configuration and the mix for them.
    ``control`` (a dtype, e.g. ``torch.bfloat16``) runs the program's own
    lower-precision path in place of the configuration's: the control of
    the comparison, never part of a benchmark run."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = spec() if bench is None else bench
    c = cell(bench, workload)
    w, conf = c["workload"], c["config"]
    cfg = json.loads((REPO / conf["file"]).read_text()) \
        if root is None else read_json("configs", w["config"], root)
    cfg.update(cfg_override or {})
    traffic = read_json("traffic", w["traffic"], root)
    traffic.update(traffic_override or {})
    limits = read_json("limits", workload, root)
    ref_mod = load("reference", w["config"], root)
    prog_mod = load("configs", w["config"], root)
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- set-up: the benchmark's own inputs, then the port's operators ------
    t_in = time.perf_counter()
    inputs = ref_mod.make_inputs(cfg, traffic, seed, device)
    # page-locked host memory: pageable copies swing the rate run to run
    frames = [f.pin_memory() if cuda else f for f in inputs["frames"]]
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    problem = prog_mod.build(cfg, traffic, inputs["shared"], device)
    problem.precision = control
    t_warm = time.perf_counter()
    n_sample = int(traffic.get("sample", 3))
    # the solutions' host buffers, touched now: the window allocates none
    free = [problem.new_output(cuda) for _ in range(n_sample + 1)]
    spans = Spans(False)
    spans.new_solve()
    problem.solve(frames[0], spans, free[-1])  # the warm solve
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {workload}: {setup_s:.3f} s (to the inputs "
        f"{t_in - t_start:.3f}, inputs {t_build - t_in:.3f}, operators "
        f"{t_warm - t_build:.3f}, warm solve "
        f"{t_start + setup_s - t_warm:.3f})")

    # -- the window: solves in a closed loop --------------------------------
    rng = random.Random(seed)
    order = list(range(len(frames)))
    rng.shuffle(order)
    sample: list = []                        # (solve index, frame, solution)
    times, errors = [], []
    spans = Spans(bool(trace))
    counters0 = problem.counters()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    sync()
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while t_end - t0 < seconds:
        fi = order[i % len(order)]
        spans.new_solve()
        ts = time.perf_counter()
        out = free.pop()
        try:
            x = problem.solve(frames[fi], spans, out)
        except Exception as exc:              # a solve that fails counts
            errors.append(f"solve {i}: {type(exc).__name__}: {exc}")
            x = None
            if len(errors) >= 3 and not times:
                t_end = time.perf_counter()
                i += 1
                break
        t_end = time.perf_counter()
        if x is not None:
            times.append(t_end - ts)
            # reservoir sampling from the seed: every solve is as likely;
            # the buffer of a solve not kept (or let go) is used again
            k = len(times)
            if len(sample) < n_sample:
                sample.append((i, fi, x))
                out = None
            else:
                j = rng.randrange(k)
                if j < n_sample:
                    out = sample[j][2]
                    sample[j] = (i, fi, x)
        if out is not None:
            free.append(out)
        i += 1
    window_s = t_end - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    counters1 = problem.counters()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = blocked_modules()

    result = dict(correct=False, attempted=i, failed=len(errors))
    metrics: dict = {}
    solves = len(times)
    if not trace:
        for m in c["end_to_end"]:
            v = {"setup_s": setup_s,
                 "solves_per_s": solves / window_s if window_s > 0 else None,
                 "solve_ms_p95": (1e3 * percentile(times, 95)
                                  if times else None),
                 "peak_mem_gib": peak / GiB if cuda else None}.get(m["name"])
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    breakdown, dev_extra = None, {}
    if trace:
        reader = load_here("trace_reader")
        tr = reader.reduce_trace(prof) if cuda else None
        if tr is not None:
            log(f"[trace] {len(tr['device'])} device events, "
                f"{tr['unlinked']} with no launch in the trace")
        dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
        pk = load_here("peaks")

        def bound_s(name):
            return pk.bound_s(load("work", name, root).work(cfg, traffic),
                              dev_name)

        def roofline(name, match, per_solve):
            """A kernel's share of its roofline over the window, in %."""
            b = bound_s(name)
            ns = reader.kernel_ns(tr, match) if tr is not None else 0
            if b is None or ns <= 0 or not solves:
                return None
            return 100.0 * b * per_solve * solves / (ns * 1e-9)

        ctx = dict(cfg=cfg, solves=solves, iterations=problem.iterations,
                   spans=spans.solves, trace=tr, reader=reader,
                   counters=(counters0, counters1), bound_s=bound_s,
                   roofline=roofline)
        for m in c["per_layer"]:
            v = load("metrics", m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if tr is not None:
            dev_extra = dict(busy_s=tr["busy_s"], window_s=tr["window_s"])
            breakdown = dict(device_ops=tr["device_ops"],
                             idle_gaps=tr["idle_gaps"])
        prof = None

    # -- the check: the reference on a sample of the window's solves -------
    del problem
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    correct = not errors and solves > 0 and not found
    if sample:
        tr0 = time.perf_counter()
        ref = ref_mod.Reference(cfg, traffic, inputs["shared"], device)
        readings = [ref.compare(frames[fi], x) for _, fi, x in sample]
        del ref
        result["readings"] = readings
        for name, lim in limits["limits"].items():
            v = max(r[name] for r in readings)
            checks[name] = dict(value=v, limit=lim)
            correct = correct and bool(v <= lim)
        log(f"[check] {len(sample)} solves of {solves} (indices "
            f"{sorted(s[0] for s in sample)}), reference "
            f"{time.perf_counter() - tr0:.3f} s")
    for e in errors[:3]:
        log(f"[failed] {e}")
    if found:
        log(f"[blocked] modules loaded in this process: {found}")
    result["correct"] = bool(correct)
    result["metrics"] = metrics
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1, memory_peak_bytes=peak)
    if cuda:
        dev["power_limit"] = _power_limit()
    dev.update(dev_extra)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["blocked_modules"] = found
    result["checks"] = checks
    for name, chk in checks.items():
        log(f"[check] {name} = {chk['value']!r} (limit {chk['limit']!r})")
    return result

