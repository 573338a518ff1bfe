"""The port's LASSO/FISTA solve (PGD) against pyxu_tpu, on the CPU.

One numpy problem goes through the JAX package's ``PGD`` and the port's
(carried across by ``pyxu_tpu_torch.convert.lasso_problem``); the iterates
agree within ``atol_for`` (2e-4 at f32, 1e-8 at f64) after 30 iterations,
and the step size is the JAX package's closed form.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
from pyxu_tpu.models.workloads import _gauss1d
from pyxu_tpu.models.workloads import lasso_deconvolution as jlasso
from pyxu_tpu.opt.solver import PGD as JPGD
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.convert import lasso_problem
from pyxu_tpu_torch.models import lasso_deconvolution
from pyxu_tpu_torch.opt.stop import MaxIter, RelError

SHAPE = (64, 48)
TAPS = (_gauss1d(2.0, 9), _gauss1d(2.0, 9))


def test_workload_data_matches():
    slv_j, _, ej = jlasso(shape=SHAPE)
    slv, fit, et = lasso_deconvolution(SHAPE, device="cpu")
    np.testing.assert_array_equal(et["x_true"].numpy(), np.asarray(ej["x_true"]))
    np.testing.assert_allclose(et["y"].numpy(), np.asarray(ej["y"]),
                               atol=atol_for(np.float32))
    assert et["K"].kernel_path == "kernel"
    assert fit["x0"].dtype == torch.float32 and not fit["x0"].any()
    assert slv._f.diff_lipschitz == pytest.approx(slv_j._f.diff_lipschitz,
                                                  rel=1e-6)


@pytest.mark.parametrize("accel", [True, False])
def test_pgd_matches_jax(accel, fdtype):
    y = np.random.default_rng(1).random(SHAPE).astype(fdtype)
    K = jlin.Stencil(SHAPE, [jnp.asarray(t) for t in TAPS], [4, 4],
                     mode="symmetric")
    fj = 0.5 * jfunc.SquaredL2Norm(SHAPE).asloss(jnp.asarray(y)) * K
    gj = 0.05 * jfunc.L1Norm(SHAPE)
    slv_j = JPGD(f=fj, g=gj, stop_rate=10)
    slv_j.fit(x0=jnp.zeros(SHAPE, fdtype), acceleration=accel,
              stop_crit=JMaxIter(30), max_iter=30)
    _, _, Kt, slv, fit = lasso_problem(y, TAPS, (4, 4), device="cpu",
                                       stop_rate=10)
    slv.fit(stop_crit=MaxIter(30), max_iter=30, acceleration=accel, **fit)
    assert slv._tau == pytest.approx(slv_j._tau, rel=1e-6)
    x = slv.solution()
    assert x.dtype == torch.from_numpy(y).dtype and bool(x.ne(0).any())
    np.testing.assert_allclose(x.numpy(), np.asarray(slv_j.solution()),
                               rtol=0, atol=atol_for(fdtype))
    assert float(slv.objective_func(slv._mstate)) == pytest.approx(
        float(slv_j.objective_func(slv_j._mstate)), rel=1e-5)
    assert list(slv.stats()[1]["iteration"]) == [10, 20, 30]


def test_pgd_estimates_an_unknown_step():
    """f without a closed-form diff-Lipschitz constant: m_init estimates it
    once (power iteration on the blur's Gram), on the state's device."""
    y = np.random.default_rng(2).random((13, 11))
    f, _, K, slv, fit = lasso_problem(y, TAPS, (4, 4), mode="constant",
                                      device="cpu")
    f.diff_lipschitz = math.inf
    slv.fit(stop_crit=MaxIter(5), max_iter=5, **fit)
    A = np.asarray(jlin.Stencil((13, 11), [jnp.asarray(t) for t in TAPS],
                                [4, 4]).asarray(dtype=np.float64))
    L = np.linalg.norm(A.reshape(143, 143), 2)
    assert slv._tau == pytest.approx(1.0 / L ** 2, rel=1e-6)
    assert f.diff_lipschitz == pytest.approx(L ** 2, rel=1e-6)
    assert isinstance(slv.default_stop_crit(), RelError)
