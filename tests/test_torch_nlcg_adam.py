"""The port's line search, NLCG and ProxAdam against pyxu_tpu, on the CPU.

The line search's steps equal the JAX package's exactly (the same trial
count for each batch element, a NaN overstep counted as a failed trial,
``a0`` from the diff-Lipschitz constant); NLCG (PR+ and Fletcher-Reeves,
with restarts) on a 2-D Tikhonov deconvolution and ProxAdam's three
variants on a 2-D LASSO agree with the JAX package's iterates within
``atol_for`` (2e-4 at f32, 1e-8 at f64) after 30 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
from pyxu_tpu.abc.operator import DiffFunc as JDiffFunc
from pyxu_tpu.math.linesearch import backtracking_linesearch as jls
from pyxu_tpu.operator.interop import from_source
from pyxu_tpu.opt.solver import NLCG as JNLCG
from pyxu_tpu.opt.solver import ProxAdam as JProxAdam
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu_torch.abc.operator import DiffFunc
from pyxu_tpu_torch.math.linesearch import backtracking_linesearch as tls
from pyxu_tpu_torch.operator.func import SquaredL2Norm
from pyxu_tpu_torch.opt.solver import NLCG, ProxAdam
from pyxu_tpu_torch.opt.stop import MaxIter, RelError
from pyxu_tpu_torch.runtime import host_read

SHAPE = (20, 16)
TAP = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
ITERS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- line search --

def test_linesearch_steps_equal_jax_batched():
    """Four batch elements that need 0, 1, 2 and 5 shrinks: the steps are
    the JAX package's bit for bit, one host read a trial."""
    x = np.random.default_rng(0).standard_normal((4, 3))
    s = np.array([1.0, 3.0, 6.0, 40.0])[:, None]
    fj, ft = jfunc.SquaredL2Norm((3,)), SquaredL2Norm((3,))
    d = -2.0 * x * s            # descent directions, scaled apart
    aj = jax.jit(lambda x, d: jls(fj, x, d))(jnp.asarray(x), jnp.asarray(d))
    n0, r0 = tls.trials, host_read.count
    at = tls(ft, torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(at.numpy(), 0.5 * 0.5 ** np.array(
        [0, 1, 2, 5]))
    assert tls.trials - n0 == 5 and host_read.count - r0 == 6
    # a0 defaults to 1/diff_lipschitz: accepted at once on a descent step
    a = tls(ft, torch.ones(3), -ft.grad(torch.ones(3)))
    assert float(a) == pytest.approx(1.0 / ft.diff_lipschitz, abs=1e-12)
    # maxiter caps the trials, as in JAX
    aj = jax.jit(lambda x, d: jls(fj, x, d, maxiter=2))(jnp.asarray(x),
                                                         jnp.asarray(d))
    at = tls(ft, torch.from_numpy(x), torch.from_numpy(d), maxiter=2)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


class _NaNBowl(DiffFunc):
    """||x||^2, NaN beyond ||x||^2 > 2."""

    def __init__(self):
        super().__init__((2,))
        self._diff_lipschitz = 2.0

    def apply(self, arr):
        v = torch.sum(arr ** 2, -1)
        return torch.where(v > 2.0, torch.nan, v)

    def grad(self, arr):
        return 2 * arr


def test_linesearch_rejects_a_nan_overstep_like_jax():
    def apply(x):
        v = jnp.sum(x ** 2, -1)
        return jnp.where(v > 2.0, jnp.nan, v)
    fj = from_source(JDiffFunc, (2,), apply=apply, grad=lambda x: 2 * x,
                     diff_lipschitz=2.0)
    x, d = np.array([0.9, 0.9]), np.array([1.0, 1.0])
    aj = jax.jit(lambda x, d: jls(fj, x, d, a0=1.0))(jnp.asarray(x),
                                                      jnp.asarray(d))
    at = tls(_NaNBowl(), torch.from_numpy(x), torch.from_numpy(d), a0=1.0)
    assert float(at) == float(aj) < 1.0
    assert bool(torch.isfinite(_NaNBowl().apply(torch.from_numpy(x + float(
        at) * d))))


# ---------------------------------------------------------------------- NLCG --

def _tikhonov(lib_func, lib_lin, y, conv, taps, lam=0.1):
    K = lib_lin.Stencil(SHAPE, [taps, taps], (2, 2), mode="symmetric")
    return (0.5 * lib_func.SquaredL2Norm(SHAPE).asloss(conv(y)) * K
            + 0.5 * lam * lib_func.SquaredL2Norm(SHAPE))


@pytest.mark.parametrize("variant,dtype", [("PR", np.float64),
                                           ("FR", np.float32)])
def test_nlcg_matches_jax(variant, dtype):
    y = np.random.default_rng(1).random(SHAPE).astype(dtype)
    fj = _tikhonov(jfunc, jlin, y, jnp.asarray, jnp.asarray(TAP))
    ft = _tikhonov(tfunc, tlin, y, torch.from_numpy, TAP)
    assert ft.diff_lipschitz == pytest.approx(fj.diff_lipschitz, rel=1e-6)
    sj = JNLCG(fj)
    sj.fit(x0=jnp.zeros(SHAPE, dtype), variant=variant, restart_rate=7,
           stop_crit=JMaxIter(ITERS), max_iter=ITERS)
    st = NLCG(ft, stop_rate=10)
    st.fit(x0=torch.zeros(SHAPE, dtype=torch.from_numpy(y).dtype),
           variant=variant, restart_rate=7, stop_crit=MaxIter(ITERS),
           max_iter=ITERS)
    assert st._mstate["k"].dtype == torch.int32 and int(st._mstate["k"]) \
        == ITERS
    x = st.solution()
    assert x.dtype == torch.from_numpy(y).dtype
    np.testing.assert_allclose(x.numpy(), np.asarray(sj.solution()),
                               atol=atol_for(dtype), rtol=0)
    assert float(st.objective_func(st._mstate)) < float(
        st.objective_func({"x": torch.zeros(SHAPE, dtype=x.dtype)}))
    assert isinstance(st.default_stop_crit(), RelError)
    assert st.default_stop_crit()._rank == 2


# ------------------------------------------------------------------ ProxAdam --

def _lasso(lib_func, lib_lin, y, conv, taps, lam=0.02):
    K = lib_lin.Stencil(SHAPE, [taps, taps], (2, 2), mode="symmetric")
    return (0.5 * lib_func.SquaredL2Norm(SHAPE).asloss(conv(y)) * K,
            lam * lib_func.L1Norm(SHAPE))


@pytest.mark.parametrize("variant", ["adam", "amsgrad", "padam"])
def test_prox_adam_matches_jax(variant):
    y = np.random.default_rng(2).random(SHAPE).astype(np.float32)
    fj, gj = _lasso(jfunc, jlin, y, jnp.asarray, jnp.asarray(TAP))
    ft, gt = _lasso(tfunc, tlin, y, torch.from_numpy, TAP)
    sj = JProxAdam(fj, gj)
    sj.fit(x0=jnp.zeros(SHAPE, jnp.float32), variant=variant,
           stop_crit=JMaxIter(ITERS), max_iter=ITERS)
    st = ProxAdam(ft, gt, stop_rate=ITERS)
    st.fit(x0=torch.zeros(SHAPE), variant=variant, stop_crit=MaxIter(ITERS),
           max_iter=ITERS)
    assert st._a == pytest.approx(sj._a, rel=1e-6)
    assert st._mstate["t"].dtype == torch.float32
    assert float(st._mstate["t"]) == ITERS
    np.testing.assert_allclose(st.solution().numpy(),
                               np.asarray(sj.solution()),
                               atol=atol_for(np.float32), rtol=0)
    assert bool(st.solution().ne(0).any())


def test_padam_at_one_half_is_amsgrad():
    y = np.random.default_rng(3).standard_normal(6).astype(np.float32)
    f = 0.5 * SquaredL2Norm((6,)).asloss(torch.from_numpy(y))
    outs = {}
    for variant in ("padam", "amsgrad"):
        slv = ProxAdam(f=f)
        slv.fit(x0=torch.zeros(6), variant=variant, stop_crit=MaxIter(50),
                max_iter=50)
        outs[variant] = slv.solution()
    assert torch.equal(outs["padam"], outs["amsgrad"])
    fj = 0.5 * jfunc.SquaredL2Norm((6,)).asloss(jnp.asarray(y))
    sj = JProxAdam(f=fj)
    sj.fit(x0=jnp.zeros(6), variant="padam", stop_crit=JMaxIter(50),
           max_iter=50)
    np.testing.assert_allclose(outs["padam"].numpy(), np.asarray(
        sj.solution()), atol=atol_for(np.float32), rtol=0)
