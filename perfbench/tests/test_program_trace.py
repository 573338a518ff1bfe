"""``program_trace`` and the metrics that read the program's ranges, on a
hand-built trace: the program's ``pyxu.*`` ranges and their device-side
copies leave ``trace_reader``'s reduction as it was, the window's idle is
split over the innermost ranges by overlap and sums to the whole, and
each metric reads what the trace holds.

    python -m pytest perfbench/tests -q
"""

import pathlib
import sys
from types import SimpleNamespace

import pytest

HERE = pathlib.Path(__file__).resolve().parent
PB = HERE.parent
sys.path.insert(0, str(PB.parent))
sys.path.insert(0, str(PB))

import harness  # noqa: E402


class _Ev:
    """A profiler event as the readers read it."""

    def __init__(self, name, dev, start, end, cid=0, annotation=False,
                 thread=1):
        self._v = (name, dev, start, end, cid, annotation, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _prof(evs):
    res = SimpleNamespace(events=lambda: list(evs))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def _traces():
    """(the benchmark's events alone, the same with the program's ranges
    and their device-side copies).  One solve of two iterations: the
    data term built, then a fit whose block launches two kernels and
    waits once on its stream, then the download."""
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    base = [_Ev("bench.build", cpu, 0, 100), _Ev("bench.fit", cpu, 100, 1000),
            _Ev("bench.download", cpu, 1000, 1100),
            _Ev("bench.fit", gpu, 320, 700, annotation=True),
            _Ev("cudaLaunchKernel", cpu, 315, 318, 1),
            _Ev("cudaLaunchKernel", cpu, 405, 408, 2),
            _Ev("cudaStreamSynchronize", cpu, 500, 600),
            _Ev("cudaMemcpyAsync", cpu, 1010, 1012, 3),
            _Ev("cudaStreamSynchronize", cpu, 1012, 1090),
            _Ev("tv_step_kernel", gpu, 320, 500, 1),
            _Ev("tv_step_kernel", gpu, 500, 700, 2),
            _Ev("Memcpy DtoH", gpu, 1020, 1080, 3)]
    program = [("op.asloss", 10, 40), ("op.argshift", 15, 35),
               ("solver.fit", 110, 990), ("solver.init", 120, 300),
               ("solver.block", 300, 900), ("kernel.tv_step", 310, 330),
               ("kernel.tv_step", 400, 420), ("solver.check", 900, 950),
               ("solver.host_read", 950, 980)]
    ranges = [_Ev("pyxu." + n, cpu, s, e) for n, s, e in program]
    copies = [_Ev("pyxu.solver.block", gpu, 320, 700, annotation=True),
              _Ev("pyxu.kernel.tv_step", gpu, 320, 500, annotation=True),
              _Ev("pyxu.kernel.tv_step", gpu, 500, 700, annotation=True)]
    return base, base + ranges + copies


def test_program_ranges_leave_the_reduction_as_it_was():
    reader = harness.load_here("trace_reader")
    base, traced = _traces()
    a = reader.reduce_trace(_prof(base))
    b = reader.reduce_trace(_prof(traced))
    assert a == b
    assert not any(n.startswith("pyxu.") for n, _ in b["device_ops"])
    assert b["busy_s"] == pytest.approx(440e-9)
    # a whole gap to the part its start lies in (the reader's rule)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"build": 320e-9, "fit": 320e-9, "download": 20e-9})


def test_idle_by_span_splits_the_idle_by_overlap():
    reader = harness.load_here("trace_reader")
    pt = harness.load_here("program_trace")
    _, traced = _traces()
    tr = reader.reduce_trace(_prof(traced))
    lines = []
    pr = pt.reduce_program(_prof(traced), tr, log=lines.append)
    assert pr["idle_by_span"] == {
        "bench.build": 70, "pyxu.op.asloss": 10, "pyxu.op.argshift": 20,
        "bench.fit": 20, "pyxu.solver.fit": 20, "pyxu.solver.init": 180,
        "pyxu.solver.block": 210, "pyxu.kernel.tv_step": 10,
        "pyxu.solver.check": 50, "pyxu.solver.host_read": 30,
        "bench.download": 40}
    idle = tr["window_s"] - tr["busy_s"]
    assert sum(pr["idle_by_span"].values()) * 1e-9 == pytest.approx(idle)
    assert [t for t, _, _ in pr["launches"]] == [315, 405, 1010]
    assert [s for _, s, _, _ in pr["syncs"]] == [500, 1012]
    assert len(pr["program"]) == 9
    assert lines and lines[0].startswith("[trace] idle by program span: "
                                         "pyxu.solver.block")


@pytest.mark.parametrize("metric, want", [
    ("fit_setup_ms", 180e-6),          # the init's host ns, one solve
    ("iter_host_ms", 300e-6),          # 600 ns of block, two iterations
    ("launches_per_iter", 1.0),        # two kernels launched in the block
    ("block_syncs_per_iter", 0.5),     # one wait in the block
    ("program_wait_ms", 530e-6),       # idle under the pyxu ranges
])
def test_metric_reads_the_hand_built_trace(metric, want):
    reader = harness.load_here("trace_reader")
    base, traced = _traces()
    for evs, expect in ((traced, want), (base, None)):
        prof = _prof(evs)
        ctx = dict(trace=reader.reduce_trace(prof), profile=prof, solves=1,
                   iterations=2)
        got = harness.load("metrics", metric).read(ctx)
        assert got == (None if expect is None else pytest.approx(expect))


def test_no_trace_no_reading():
    for m in ("fit_setup_ms", "iter_host_ms", "launches_per_iter",
              "block_syncs_per_iter", "program_wait_ms"):
        assert harness.load("metrics", m).read(
            dict(trace=None, solves=3, iterations=5)) is None
