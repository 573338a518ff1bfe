"""The port's CondatVu TV solve against pyxu_tpu, on the CPU.

The JAX package's ``tv_deconvolution`` runs its generic operator path on
the CPU; the port solves the same problem, carried across by
``pyxu_tpu_torch.convert``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
from pyxu_tpu.models.workloads import _gauss1d
from pyxu_tpu.models.workloads import tv_deconvolution as jtv
from pyxu_tpu.opt.solver import CondatVu as JCondatVu
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu.opt.stop import RelError as JRelError
from pyxu_tpu_torch.convert import tv_problem
from pyxu_tpu_torch.models import tv_deconvolution
from pyxu_tpu_torch.ops import fused_tv
from pyxu_tpu_torch.opt.stop import AbsError, MaxIter, RelError

SHAPE = (64, 48)
TAPS = (_gauss1d(2.0, 9), _gauss1d(2.0, 9))


def _jax_solve(y, iters, stop=None, stop_rate=1):
    """The JAX package's solve of the TV problem on data ``y``
    (``stop="default"``: the solver's default criterion)."""
    H, W = y.shape
    K = jlin.Stencil((H, W), [jnp.asarray(t) for t in TAPS], [4, 4],
                     mode="symmetric")
    f = 0.5 * jfunc.SquaredL2Norm((H, W)).asloss(jnp.asarray(y)) * K
    D = jlin.Gradient((H, W), mode="symmetric")
    h = 0.01 * jfunc.L21Norm((2, H, W), l2_axis=0)
    slv = JCondatVu(f=f, h=h, K=D, stop_rate=stop_rate)
    if stop is None:
        stop = JMaxIter(iters)
    slv.fit(x0=jnp.asarray(y), max_iter=iters,
            stop_crit=None if stop == "default" else stop)
    return slv


def test_workload_data_matches():
    _, _, ej = jtv(shape=SHAPE)
    _, _, et = tv_deconvolution(SHAPE, device="cpu")
    np.testing.assert_allclose(et["x_true"].numpy(), np.asarray(ej["x_true"]))
    np.testing.assert_allclose(et["y"].numpy(), np.asarray(ej["y"]),
                               atol=atol_for(np.float32))


def test_generic_solve_matches_jax_f32():
    slv_j, kw, ej = jtv(shape=SHAPE)
    slv_j.fit(stop_crit=JMaxIter(20), max_iter=20, **kw)
    y = np.asarray(ej["y"])
    _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu", fuse=False)
    slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
    assert slv.fused_path is None
    assert (slv._tau, slv._sigma, slv._rho) == pytest.approx(
        (slv_j._tau, slv_j._sigma, slv_j._rho), rel=1e-6)
    np.testing.assert_allclose(slv.solution().numpy(),
                               np.asarray(slv_j.solution()),
                               atol=atol_for(np.float32), rtol=0)
    np.testing.assert_allclose(slv._mstate["z"].numpy(),
                               np.asarray(slv_j._mstate["z"]),
                               atol=atol_for(np.float32), rtol=0)


def test_generic_solve_matches_jax_f64():
    y = np.random.default_rng(1).random(SHAPE)
    slv_j = _jax_solve(y, 20)
    _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu", fuse=False)
    slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
    assert slv.solution().dtype == torch.float64
    np.testing.assert_allclose(slv.solution().numpy(),
                               np.asarray(slv_j.solution()),
                               atol=atol_for(np.float64), rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_plain_matches_generic_with_tail(dtype, monkeypatch):
    """stop_rate 10 with K = 3: each segment runs 3 K-steps and 1 tail
    step through the plain fused versions (K set to 3 here: the TV path's
    own depth, ``fused_tv.N_STEPS``, is 1)."""
    monkeypatch.setattr(fused_tv, "N_STEPS", 3)
    y = np.random.default_rng(2).random((100, 120)).astype(dtype)
    sols = {}
    for fuse in (True, False):
        _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu",
                                       fuse=fuse, stop_rate=10)
        slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
        assert slv.fused_path == ("plain" if fuse else None)
        assert slv._m_step2_iters == (3 if fuse else 0)
        sols[fuse] = slv.solution().numpy()
    np.testing.assert_allclose(sols[True], sols[False], rtol=0,
                               atol=atol_for(dtype))


def test_maxiter_stops_at_segment_boundary():
    y = np.random.default_rng(3).random(SHAPE).astype(np.float32)
    _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu",
                                   stop_rate=4)
    slv.fit(stop_crit=MaxIter(10), max_iter=100, **fit)
    _, hist = slv.stats()
    assert list(hist["iteration"]) == [4, 8, 12]
    assert list(hist["N_iter"]) == [4, 8, 12]


def test_relerror_stops_like_jax():
    y = np.random.default_rng(4).random(SHAPE).astype(np.float32)
    stop_j = JRelError(eps=1e-3, var="x", rank=2)
    slv_j = _jax_solve(y, 500, stop=stop_j, stop_rate=5)
    _, hist_j = slv_j.stats()
    _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu", stop_rate=5)
    slv.fit(stop_crit=RelError(eps=1e-3, var="x", rank=2), max_iter=500,
            **fit)
    _, hist = slv.stats()
    assert hist["iteration"][-1] == hist_j["iteration"][-1] < 500
    np.testing.assert_allclose(hist["RelError[x]"][1:],
                               hist_j["RelError[x]"][1:], rtol=1e-3)


def test_default_and_combined_criteria():
    y = np.random.default_rng(5).random(SHAPE).astype(np.float32)
    slv_j = _jax_solve(y, 60, stop="default", stop_rate=5)
    _, _, _, slv, fit = tv_problem(y, TAPS, (4, 4), device="cpu",
                                   stop_rate=5)
    slv.fit(max_iter=60, **fit)                  # RelError(x) & RelError(z)
    _, hist = slv.stats()
    _, hist_j = slv_j.stats()
    assert hist["iteration"][-1] == hist_j["iteration"][-1] == 60
    for col in ("RelError[x]", "RelError[z]"):
        np.testing.assert_allclose(hist[col][1:], hist_j[col][1:], rtol=1e-3)
    slv.fit(stop_crit=MaxIter(15) | AbsError(eps=1e9), max_iter=500, **fit)
    assert slv.stats()[1]["iteration"][-1] == 5  # AbsError fires at once
