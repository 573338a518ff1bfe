"""The port's solver engine and stop criteria against pyxu_tpu, on the CPU.

One numpy problem (a 1-D LASSO over a 3-tap blur, or the 64x48 TV
deconvolution) goes through the JAX package's engine and the port's:
BLOCK, MANUAL and ASYNC modes, the history's columns, warm starts,
``update_operands``, checkpoints read across the two packages, the
precision schedule, the host-part criteria and the eager
``clear``/``stop``/``info`` protocol.  Iterates agree within ``atol_for``
(2e-4 at f32, 1e-8 at f64); where the port runs the same steps twice it
must give the same bits.
"""

import datetime as dt
import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu.opt.stop as jstop
from pyxu_tpu.abc.solver import Mode as JMode
from pyxu_tpu.abc.solver import Solver as JSolver
from pyxu_tpu.models.workloads import _gauss1d
from pyxu_tpu.opt.solver import PGD as JPGD
from pyxu_tpu.opt.solver import CondatVu as JCondatVu
from pyxu_tpu_torch.abc import Mode
from pyxu_tpu_torch.abc.solver import Solver
from pyxu_tpu_torch.convert import tv_problem
from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
from pyxu_tpu_torch.operator.linop import Stencil
from pyxu_tpu_torch.opt import stop as tstop
from pyxu_tpu_torch.opt.solver import PGD
from pyxu_tpu_torch.runtime import host_read

N = 32
TAP = np.array([0.25, 0.5, 0.25], np.float32)
F32 = atol_for(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _y(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _jlasso(y, lam=0.05):
    K = jlin.Stencil((y.size,), jnp.asarray(TAP), (1,), mode="constant")
    return (0.5 * jfunc.SquaredL2Norm((y.size,)).asloss(jnp.asarray(y)) * K,
            lam * jfunc.L1Norm((y.size,)))


def _tlasso(y, lam=0.05):
    K = Stencil((y.size,), TAP, (1,), mode="constant")
    return (0.5 * SquaredL2Norm((y.size,)).asloss(torch.from_numpy(y)) * K,
            lam * L1Norm((y.size,)))


def _x0(n=N):
    return torch.zeros(n)


def _close(t, j, atol=F32):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


# ------------------------------------------------------------ modes, history --

def test_history_columns_and_modes_match_jax():
    """BLOCK with Memorize/MaxIter/track_objective: the history's names and
    values equal the JAX package's; MANUAL gives BLOCK's bits (stop_rate
    1) and the JAX package's MANUAL history."""
    y = _y()
    kw = dict(max_iter=25, track_objective=True)
    sj = JPGD(*_jlasso(y), stop_rate=5)
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.Memorize("x") | jstop.MaxIter(25),
           **kw)
    st = PGD(*_tlasso(y), stop_rate=5)
    st.fit(x0=_x0(), stop_crit=tstop.Memorize("x") | tstop.MaxIter(25), **kw)
    hj, ht = sj.stats()[1], st.stats()[1]
    assert ht.dtype.names == hj.dtype.names == (
        "Memorize[x]", "N_iter", "iteration", "objective")
    for name in ("iteration", "N_iter"):
        assert ht[name].dtype == hj[name].dtype == np.int32
        np.testing.assert_array_equal(ht[name], hj[name])
    assert ht["objective"].dtype == np.float32
    for name in ("Memorize[x]", "objective"):
        np.testing.assert_allclose(ht[name], hj[name], rtol=1e-5, atol=F32)
    assert list(ht["iteration"]) == [5, 10, 15, 20, 25]
    _close(st.solution(), sj.solution())

    block = PGD(*_tlasso(y))
    block.fit(x0=_x0(), stop_crit=tstop.MaxIter(25), max_iter=25)
    man = PGD(*_tlasso(y))
    gen = man.fit(x0=_x0(), stop_crit=tstop.MaxIter(25), max_iter=25,
                  mode=Mode.MANUAL)
    states = list(gen)
    assert len(states) == 25
    assert torch.equal(man.solution(), block.solution())
    jm = JPGD(*_jlasso(y))
    for _ in jm.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxIter(25), max_iter=25,
                    mode=JMode.MANUAL):
        pass
    _close(man.solution(), jm.solution())
    hm, hjm = man.stats()[1], jm.stats()[1]
    assert hm.dtype.names == hjm.dtype.names == ("iteration", "N_iter")
    np.testing.assert_array_equal(hm["iteration"], hjm["iteration"])
    np.testing.assert_array_equal(hm["N_iter"], hjm["N_iter"])
    np.testing.assert_array_equal(block.stats()[1]["iteration"],
                                  np.arange(1, 26))


def test_host_metric_column_is_nan_outside_segment_ends():
    """``duration`` is recorded once a segment, at its last row, and NaN
    elsewhere, as in the JAX package; the segment is the same size."""
    y = _y(1)
    kw = dict(max_iter=40, segment_size=10)
    sj = JPGD(*_jlasso(y), stop_rate=5)
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxDuration(
        dt.timedelta(hours=1)) | jstop.MaxIter(40), **kw)
    st = PGD(*_tlasso(y), stop_rate=5)
    st.fit(x0=_x0(), stop_crit=tstop.MaxDuration(
        dt.timedelta(hours=1)) | tstop.MaxIter(40), **kw)
    hj, ht = sj.stats()[1], st.stats()[1]
    assert ht.dtype.names == hj.dtype.names == ("N_iter", "iteration",
                                                "duration")
    np.testing.assert_array_equal(np.isnan(ht["duration"]),
                                  np.isnan(hj["duration"]))
    assert list(np.flatnonzero(~np.isnan(ht["duration"]))) == [1, 3, 5, 7]
    _close(st.solution(), sj.solution())
    # the segment bound of a criterion with a host part, as in JAX
    for s, crit in ((JPGD(*_jlasso(y), stop_rate=7), jstop.MaxDuration(1.0)),
                    (PGD(*_tlasso(y), stop_rate=7), tstop.MaxDuration(1.0))):
        s._fit_init(crit, 1000, None, False)
        assert s._segment == 50
        s._fit_init(crit, 1000, 20, False)
        assert s._segment == 20


def test_block_mode_reads_the_host_once_a_block():
    """A device-side criterion costs one read a block of stop_rate steps;
    MaxIter, decided on the host, none (so the last block of
    ``RelError | MaxIter`` is decided with no read)."""
    st = PGD(*_tlasso(_y(2)), stop_rate=4)
    n0 = host_read.count
    st.fit(x0=_x0(), stop_crit=tstop.RelError(0.0) | tstop.MaxIter(20),
           max_iter=20)
    assert host_read.count - n0 == 4
    n0 = host_read.count
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20)
    assert host_read.count == n0
    assert list(st.stats()[1]["iteration"]) == [4, 8, 12, 16, 20]


def test_combined_criteria_and_abs_error():
    st = PGD(*_tlasso(_y(3)))
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(10) & tstop.MaxIter(20),
           max_iter=100)
    assert st.stats()[1]["iteration"][-1] == 20
    crit = tstop.AbsError(eps=1e-5, var="x", rank=1,
                          f=lambda x: x - st._g.prox(x - st._f.grad(x), 1.0))
    st.fit(x0=_x0(), stop_crit=crit | tstop.MaxIter(5000), max_iter=5000)
    assert st.stats()[1]["iteration"][-1] < 5000
    # no compiled segment to key: a criterion's key is its identity
    c = tstop.RelError(1e-3) | tstop.ManualStop()
    assert c.cache_key() == c.cache_key() != (c | c).cache_key()


# ------------------------------------------------------------------ sessions --

def test_warm_start_continues_like_jax():
    y = _y(4)
    st = PGD(*_tlasso(y))
    with pytest.raises(AssertionError):
        st.fit(stop_crit=tstop.MaxIter(2), warm_start=True)
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(5), max_iter=5)
    x5 = st.solution().clone()
    st.fit(stop_crit=tstop.MaxIter(5), max_iter=5, warm_start=True)
    cold = PGD(*_tlasso(y))
    cold.fit(x0=_x0(), stop_crit=tstop.MaxIter(10), max_iter=10)
    assert torch.equal(st.solution(), cold.solution())
    assert not torch.equal(x5, st.solution())
    sj = JPGD(*_jlasso(y))
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxIter(5), max_iter=5)
    sj.fit(stop_crit=jstop.MaxIter(5), max_iter=5, warm_start=True)
    _close(st.solution(), sj.solution())


def test_update_operands_matches_a_fresh_solve():
    y1, y2 = _y(5), _y(6)
    st = PGD(*_tlasso(y1))
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(8), max_iter=8)
    st.update_operands(f=_tlasso(y2)[0])
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(8), max_iter=8)
    fresh = PGD(*_tlasso(y2))
    fresh.fit(x0=_x0(), stop_crit=tstop.MaxIter(8), max_iter=8)
    assert torch.equal(st.solution(), fresh.solution())
    sj = JPGD(*_jlasso(y1))
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxIter(8), max_iter=8)
    sj.update_operands(f=_jlasso(y2)[0])
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxIter(8), max_iter=8)
    _close(st.solution(), sj.solution())
    for s, f in ((st, _tlasso(y1)[0]), (sj, _jlasso(y1)[0])):
        with pytest.raises(AssertionError):
            s.update_operands(nope=f)
        with pytest.raises(AssertionError):
            s.update_operands(f=np.zeros(3))


# --------------------------------------------------------------- checkpoints --

def test_npz_checkpoints_read_across_packages(tmp_path):
    y = _y(7)
    sj = JPGD(*_jlasso(y), folder=tmp_path / "jax", writeback_rate=10,
              stop_rate=10)
    sj.fit(x0=jnp.zeros(N), stop_crit=jstop.MaxIter(30), max_iter=30)
    st = PGD(*_tlasso(y), folder=tmp_path / "torch", writeback_rate=10,
             stop_rate=10)
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(30), max_iter=30)
    assert st.datafile.name == "data.npz" and st.logfile.name == "solver.log"
    m_t, h_t = Solver.read_checkpoint(tmp_path / "jax")     # JAX -> port
    m_j, h_j = JSolver.read_checkpoint(tmp_path / "torch")  # port -> JAX
    assert set(m_t) == set(m_j) == {"x"}
    np.testing.assert_array_equal(m_t["x"], np.asarray(sj.solution()))
    np.testing.assert_array_equal(m_j["x"], st.solution().numpy())
    np.testing.assert_allclose(m_j["x"], m_t["x"], atol=F32, rtol=0)
    assert h_t.dtype == h_j.dtype
    np.testing.assert_array_equal(h_t["iteration"], [10, 20, 30])
    np.testing.assert_array_equal(h_j["iteration"], h_t["iteration"])
    # resume from the checkpoint
    st2 = PGD(*_tlasso(y))
    st2.fit(x0=m_t["x"], stop_crit=tstop.MaxIter(5), max_iter=5,
            device="cpu")
    assert bool(st2.solution().isfinite().all())


def test_torch_backend_round_trip(tmp_path):
    y = _y(8)
    st = PGD(*_tlasso(y), folder=tmp_path / "run", writeback_rate=4,
             checkpoint_backend="torch", log_var=(), stop_rate=4)
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(8), max_iter=8)
    assert st.datafile.name == "ckpt.pt"
    mstate, hist = PGD.read_checkpoint(tmp_path / "run")
    assert set(mstate) == {"x", "x_prev", "k"}
    for k, v in st._mstate.items():
        assert torch.equal(mstate[k], v) and mstate[k].device == v.device
    np.testing.assert_array_equal(hist["iteration"], [4, 8])
    with pytest.raises(ValueError, match="torch"):
        PGD(*_tlasso(y), checkpoint_backend="orbax")
    (tmp_path / "orbax" / "ckpt").mkdir(parents=True)
    with pytest.raises(ValueError, match="torch"):
        PGD.read_checkpoint(tmp_path / "orbax")
    with pytest.raises(AssertionError):
        PGD(*_tlasso(y), operand_mode="other")


def test_refit_with_a_new_folder_gets_its_own_log(tmp_path):
    st = PGD(*_tlasso(_y(9)), folder=tmp_path / "runA", writeback_rate=10,
             verbosity=10)
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20)
    st._folder = tmp_path / "runB"
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20)
    for h in st._astate["logger"].handlers:
        h.flush()
    assert (tmp_path / "runA" / "solver.log").exists()
    text = (tmp_path / "runB" / "solver.log").read_text()
    assert "[20] N_iter=2.0000e+01" in text


def test_crash_keeps_the_last_good_state(tmp_path):
    """A segment that raises leaves the state of its start and logs the
    error."""
    st = PGD(*_tlasso(_y(10)), folder=tmp_path / "crash", stop_rate=2)
    step = st.m_step

    def failing(s):
        if float(s["k"]) >= 5:
            raise RuntimeError("boom")
        return step(s)
    st.m_step = failing
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20,
           segment_size=4)
    assert float(st._mstate["k"]) == 4.0
    assert list(st.stats()[1]["iteration"]) == [2, 4]
    for h in st._astate["logger"].handlers:
        h.flush()
    assert "boom" in st.logfile.read_text()


def test_schedule_phase_that_raises_ends_the_fit(tmp_path):
    """A phase whose step refuses its dtype (as the stencil kernel refuses
    bfloat16 on the card) raises out of the schedule: no later phase runs,
    the state is the phase's start, the error is logged."""
    st = PGD(*_tlasso(_y(10)), folder=tmp_path / "sched", stop_rate=2)
    step = st.m_step

    def picky(s):
        if s["x"].dtype == torch.bfloat16:
            raise ValueError("no bfloat16")
        return step(s)
    st.m_step = picky
    with pytest.raises(ValueError, match="no bfloat16"):
        st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20,
               precision_schedule=[(torch.bfloat16, 10),
                                   (torch.float32, None)])
    assert st.phase_log == [] and float(st._mstate["k"]) == 0.0
    assert st._mstate["x"].dtype == torch.bfloat16
    assert not st._dtype_lock
    for h in st._astate["logger"].handlers:
        h.flush()
    assert "no bfloat16" in st.logfile.read_text()


# ---------------------------------------------------------- precision schedule --

def test_precision_schedule_matches_jax():
    y = _y(11, 60)
    x0t, x0j = torch.zeros(60), jnp.zeros(60, jnp.float32)

    def obj(f, g, x):
        return float(f.apply(x) + g.apply(x))
    ft, gt = _tlasso(y, 0.02)
    ref = PGD(ft, gt)
    ref.fit(x0=x0t, stop_crit=tstop.MaxIter(400), max_iter=400)
    st = PGD(ft, gt)
    st.fit(x0=x0t, stop_crit=tstop.MaxIter(400), max_iter=400,
           precision_schedule=[(torch.bfloat16, 250), (torch.float32, None)])
    assert st.solution().dtype == torch.float32
    assert [p["dtype"] for p in st.phase_log] == ["bfloat16", "float32"]
    assert [p["iterations"] for p in st.phase_log] == [250, 150]
    assert st._mstate["k"].dtype == torch.float32      # counters stay f32
    o_sched, o_f32 = obj(ft, gt, st.solution()), obj(ft, gt, ref.solution())
    assert o_sched <= o_f32 * 1.02 + 1e-6
    fj, gj = _jlasso(y, 0.02)
    sj = JPGD(fj, gj)
    sj.fit(x0=x0j, stop_crit=jstop.MaxIter(400), max_iter=400,
           precision_schedule=[(jnp.bfloat16, 250), (jnp.float32, None)])
    o_j = obj(fj, gj, sj.solution())
    assert abs(o_sched - o_j) <= 1e-2 * abs(o_j)
    # phase budgets under a tight final criterion, and the hard cap
    st.fit(x0=x0t, stop_crit=tstop.RelError(1e-3), max_iter=300,
           precision_schedule=[(torch.bfloat16, 50), (torch.float32, None)])
    assert st.phase_log[0]["iterations"] == 50
    assert 50 + st.stats()[1]["iteration"][-1] <= 300
    st.fit(x0=x0t, stop_crit=tstop.MaxIter(100), max_iter=100,
           precision_schedule=[("bfloat16", 100), (torch.float32, None)])
    assert len(st.phase_log) == 1 and st.phase_log[0]["iterations"] == 100
    assert st.solution().dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["empty", "none-first", "manual", "cap"])
def test_precision_schedule_validation_as_in_jax(case):
    pick = {"empty": ([], {}, "non-empty"),
            "none-first": ([("bfloat16", None), ("float32", None)], {},
                           "positive iteration"),
            "manual": ([("float32", None)], {"mode": "MANUAL"}, "BLOCK"),
            "cap": ([("bfloat16", 80), ("float32", 80)], {"max_iter": 100},
                    "hard cap")}
    sched, kw, match = pick[case]
    for s, x0, mode, dtype in (
            (JPGD(*_jlasso(_y())), jnp.zeros(N), JMode, jnp.dtype),
            (PGD(*_tlasso(_y())), _x0(), Mode, lambda d: getattr(torch, d))):
        kw2 = {k: (getattr(mode, v) if k == "mode" else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            s.fit(x0=x0, precision_schedule=[(dtype(d), n)
                                             for d, n in sched], **kw2)


def test_tv_schedule_rematches_each_phase():
    """TV 64x48 through bf16 then f32 phases: the fusion is matched again on
    each phase's state, and the objective is the JAX package's within 1e-2
    (its own criterion for a schedule, ``tests/test_fused_tv.py``)."""
    H, W = 64, 48
    taps = (_gauss1d(2.0, 9), _gauss1d(2.0, 9))
    y = np.random.default_rng(3).random((H, W), np.float32)
    kw = dict(stop_crit=None, max_iter=48, segment_size=24)
    sched = [(torch.bfloat16, 24), (torch.float32, None)]
    objs = {}
    for fuse in (True, False):
        f, h, D, st, fit = tv_problem(y, taps, (4, 4), device="cpu",
                                      stop_rate=12, fuse=fuse)
        st.fit(**{**kw, "stop_crit": tstop.MaxIter(48)}, **fit,
               precision_schedule=sched)
        assert st.solution().dtype == torch.float32
        want = "plain" if fuse else None
        assert [p["fused_path"] for p in st.phase_log] == [want, want]
        objs[fuse] = float(f.apply(st.solution()) + h.apply(D.apply(
            st.solution())))
    K = jlin.Stencil((H, W), [jnp.asarray(t) for t in taps], [4, 4],
                     mode="symmetric")
    fj = 0.5 * jfunc.SquaredL2Norm((H, W)).asloss(jnp.asarray(y)) * K
    Dj = jlin.Gradient((H, W), mode="symmetric")
    hj = 0.01 * jfunc.L21Norm((2, H, W), l2_axis=0)
    sj = JCondatVu(f=fj, h=hj, K=Dj, stop_rate=12)
    sj.fit(x0=jnp.asarray(y), **{**kw, "stop_crit": jstop.MaxIter(48)},
           precision_schedule=[(jnp.bfloat16, 24), (jnp.float32, None)])
    xj = sj.solution()
    oj = float(fj.apply(xj) + hj.apply(Dj.apply(xj)))
    for o in objs.values():
        assert abs(o - oj) / abs(oj) < 1e-2, (objs, oj)


# ------------------------------------------------------ host criteria, ASYNC --

def test_async_stop_and_host_criteria():
    """ASYNC with ManualStop stops on stop(); a later BLOCK fit runs to its
    criterion; MaxDuration, MaxDuration & AbsError (latched host flag) and
    MaxCarbon fire; ~0.5 s of waiting in all."""
    st = PGD(*_tlasso(_y(12)))
    st.fit(x0=_x0(), stop_crit=tstop.ManualStop(), max_iter=10 ** 6,
           segment_size=50, mode=Mode.ASYNC)
    time.sleep(0.15)
    assert st.busy()
    st.stop()
    assert not st.busy() and not st._astate["worker"].is_alive()
    k = st.stats()[1]["iteration"][-1]
    assert 0 < k < 10 ** 6 and k % 50 == 0
    assert bool(st.solution().isfinite().all())
    st.fit(x0=_x0(), stop_crit=tstop.MaxIter(500), max_iter=500)
    assert st.stats()[1]["iteration"][-1] == 500
    st.fit(x0=_x0(), stop_crit=tstop.MaxDuration(dt.timedelta(seconds=0.15))
           | tstop.MaxIter(10 ** 6), max_iter=10 ** 6, segment_size=100)
    assert st.stats()[1]["iteration"][-1] < 10 ** 6
    crit = tstop.MaxDuration(dt.timedelta(seconds=0.1)) & \
        tstop.AbsError(eps=1e30, var="x", rank=1)
    st.fit(x0=_x0(), stop_crit=crit, max_iter=10 ** 6, segment_size=50)
    assert st.stats()[1]["iteration"][-1] < 10 ** 6
    c = tstop.MaxCarbon(budget_kg=1e-12)
    c.host_init()
    time.sleep(0.01)
    assert c.host_check() and c.has_host_part()
    assert c.host_metrics()["carbon_kg"] > 0
    # the budget in seconds equals the JAX package's for the same watts
    for w in (200.0, 700.0):
        assert tstop.MaxCarbon(1e-3, watts=w)._budget == pytest.approx(
            jstop.MaxCarbon(1e-3, watts=w)._budget, rel=1e-12)
    assert tstop.MaxCarbon(1e-3)._watts == 700.0


def test_eager_protocol_matches_jax():
    for lib, state in ((jstop, {"x": jnp.ones(4)}),
                       (tstop, {"x": torch.ones(4)})):
        sc = lib.MaxIter(3)
        sc.clear()
        assert [sc.stop(state) for _ in range(5)] == [False] * 3 + [True] * 2
        assert sc.info()["N_iter"] == 4.0
        sc = lib.MaxDuration(dt.timedelta(seconds=1e4)) & lib.MaxIter(1)
        sc.clear()
        assert sc.stop(state) is False and sc.stop(state) is False
        sc = lib.RelError(1e-9)
        sc.clear()
        assert not sc.stop(state) and sc.stop(state)
    rng = np.random.default_rng(13)
    xs = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    infos = []
    for lib, conv in ((jstop, jnp.asarray), (tstop, torch.from_numpy)):
        sc = lib.RelError(1e-3) | lib.Memorize("x") | lib.AbsError(0.1)
        sc.clear()
        fired = [sc.stop({"x": conv(x)}) for x in xs]
        infos.append((fired, sc.info()))
    assert infos[0][0] == infos[1][0]
    assert set(infos[0][1]) == set(infos[1][1]) == {
        "RelError[x]", "Memorize[x]", "AbsError[x]"}
    for k, v in infos[0][1].items():
        assert infos[1][1][k] == pytest.approx(v, rel=1e-6)


def test_show_progress_logs_each_segment(caplog):
    st = PGD(*_tlasso(_y(14)), show_progress=True)
    with caplog.at_level(logging.INFO):
        st.fit(x0=_x0(), stop_crit=tstop.MaxIter(20), max_iter=20,
               segment_size=10)
    assert sum("N_iter" in r.getMessage() for r in caplog.records) == 2
