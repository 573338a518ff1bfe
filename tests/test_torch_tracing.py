"""The port's spans (``pyxu_tpu_torch/utils/profiler.py`` ``span``) on the
CPU, on a 64x96 TV deconvolution by Condat-Vu, fused (``tv_step``'s plain
version) and generic (under x >= 0: the stencil's plain version):

* with no profiler and no hook, a fit opens no ``record_function``;
* under ``torch.profiler`` the ranges appear and nest: the engine's init
  in its fit, the step sizes and the fusion match in the init, the
  operands' and kernels' ranges in a block, the algebra's while f is built;
* tracing leaves the solution's bits as they are;
* the hook ``utils.profiler.SPAN`` takes the NUFFT's set-up parts, and
  ``operator.linop.nufft`` keeps no hook of its own;
* an ASYNC fit's ranges land in :func:`utils.profiler.trace`'s file from
  the worker thread.
"""

import json

import numpy as np
import pytest
import torch

import pyxu_tpu_torch.operator as O
import pyxu_tpu_torch.operator.linop.nufft as tnu
from pyxu_tpu_torch.abc.solver import Mode
from pyxu_tpu_torch.opt.solver import CondatVu
from pyxu_tpu_torch.opt.stop import MaxIter
from pyxu_tpu_torch.utils import profiler as tprof

SHAPE = (64, 96)
ITERS = 3
OPERANDS = ("op.f.grad", "op.g.prox", "op.h.fenchel_prox", "op.K.apply",
            "op.K.adjoint")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops():
    x = np.arange(9) - 4
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k = (k / k.sum()).astype(np.float32)
    K = O.Stencil(SHAPE, [k, k], [4, 4], mode="symmetric")
    D = O.Gradient(SHAPE, mode="symmetric")
    h = 0.01 * O.L21Norm((2,) + SHAPE, l2_axis=0)
    y = torch.from_numpy(np.random.default_rng(0).random(SHAPE,
                                                         dtype=np.float32))
    return K, D, h, y


def _solve(path, mode=Mode.BLOCK):
    """Build the data term and the solver, then fit: the fused path, or
    the generic one under x >= 0."""
    K, D, h, y = _ops()
    g = O.PositiveOrthant(SHAPE) if path == "generic" else None
    f = 0.5 * O.SquaredL2Norm(SHAPE).asloss(y) * K
    slv = CondatVu(f=f, g=g, h=h, K=D, stop_rate=ITERS)
    slv.fit(x0=y, stop_crit=MaxIter(ITERS), max_iter=ITERS, mode=mode)
    return slv


def _ranges(prof):
    """The port's ranges: ``[(name without "pyxu.", start, end, thread)]``."""
    return [(e.name()[len("pyxu."):], e.start_ns(), e.end_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("pyxu.")]


def _within(r, outer):
    return any(o[3] == r[3] and o[1] <= r[1] and r[2] <= o[2] for o in outer)


@pytest.mark.parametrize("path", ["fused", "generic"])
def test_no_range_without_a_profiler(path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was opened with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    slv = _solve(path)
    assert slv.fused_path == ("plain" if path == "fused" else None)
    assert slv._last_k == ITERS


@pytest.mark.parametrize("path", ["fused", "generic"])
def test_ranges_nest_under_a_profiler(path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve(path)
    rs = _ranges(prof)
    by = {}
    for r in rs:
        by.setdefault(r[0], []).append(r)
    (fit,) = by["solver.fit"]
    (init,) = by["solver.init"]
    (block,) = by["solver.block"]
    assert _within(init, [fit]) and _within(block, [fit])
    for name in ("solver.step_sizes", "solver.fuse_match"):
        assert by[name] and all(_within(r, [init]) for r in by[name])
    for name in ("solver.check", "solver.host_read"):
        assert by[name] and all(_within(r, [fit]) for r in by[name])
    # the algebra's ranges while f is built, before the fit
    for name in ("op.asloss", "op.argshift", "op.scale", "op.compose"):
        assert by[name] and any(r[2] <= fit[1] for r in by[name]), name
    assert all(_within(r, by["op.asloss"]) for r in by["op.argshift"]
               if r[2] <= fit[1])
    # an iteration's ranges: in the block, or (Kᵀy at the match) the init
    inner = [r for r in rs if r[0].startswith("kernel.")
             or r[0] in OPERANDS]
    assert all(_within(r, [block, init]) for r in inner)
    in_block = [r[0] for r in inner if _within(r, [block])]
    if path == "fused":
        assert in_block == ["kernel.tv_step"] * ITERS
    else:
        for name in OPERANDS:
            assert in_block.count(name) == ITERS, name
        # six correlations an iteration (K, Kᵀ, D, Dᵀ's two), and once
        # Kᵀy, the data term's linear part, at the first gradient
        assert in_block.count("kernel.stencil") == 6 * ITERS + 1


@pytest.mark.parametrize("path", ["fused", "generic"])
def test_tracing_keeps_the_bits(path):
    off = _solve(path).solution()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _solve(path).solution()
    assert torch.equal(off, on)


def test_span_hook_takes_the_nufft_parts():
    assert not hasattr(tnu, "SPAN") and not hasattr(tnu, "_span")
    seen = []

    def hook(name):
        seen.append(name)
        return tprof._OFF

    x = np.random.default_rng(1).uniform(-np.pi, np.pi, (50, 2))
    tprof.SPAN = hook
    try:
        A = tnu.NUFFT.type1(x, (12, 10), eps=1e-6, dtype=torch.float64,
                            device="cpu")
        A.apply(torch.ones((50, 2), dtype=torch.float64))
    finally:
        tprof.SPAN = None
    for name in ("nufft.points", "nufft.phi_hat", "nufft.plan",
                 "nufft.spread", "nufft.fft", "kernel.nufft_spread"):
        assert name in seen, (name, seen)


def test_async_fit_ranges_from_the_worker(tmp_path):
    with tprof.trace(str(tmp_path)):
        slv = _solve("generic", mode=Mode.ASYNC)
        slv._astate["worker"].join(timeout=120)
    assert not slv.busy()
    evs = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tid = {e.get("tid") for e in evs if e.get("name") == "pyxu.solver.fit"}
    work = {e.get("tid") for e in evs if e.get("name") == "pyxu.solver.block"}
    assert tid and work and not (tid & work)
