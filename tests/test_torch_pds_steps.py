"""The port's primal-dual step sizes against pyxu_tpu, on the CPU, for
operators with no declared Lipschitz constant.

A dense 20x12 f32 LinOp, made from a numpy seed, declares no Lipschitz
constant, so ``CondatVu.m_init`` estimates ||K|| (and the diff-Lipschitz
constant of f = 1/2 ||K . - y||^2) by power iteration, in both packages.
The two power iterations start from different random vectors (``jax.
random`` against ``torch.Generator``), so the estimates, and tau and sigma
with them, agree to the iteration's accuracy, not bit for bit: 64 steps
at this matrix's ratio of its two largest singular values leave a
relative error far below ``RTOL``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.operator.func as jfunc
from pyxu_tpu.abc import LinOp as JLinOp
from pyxu_tpu.opt.solver import CondatVu as JCondatVu
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
from pyxu_tpu_torch.opt.solver import CondatVu
from pyxu_tpu_torch.opt.stop import MaxIter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M, N = 20, 12
ITERS = 30
RTOL = 1e-4          # power iteration from two random starts (see above)
ATOL = 2e-4          # f32 conformance tolerance of the iterates


class _Dense(LinOp):
    """x -> A x for a dense (M, N) matrix, no Lipschitz constant declared."""

    def __init__(self, A: torch.Tensor):
        super().__init__((A.shape[1],), (A.shape[0],))
        self._A = A

    def apply(self, arr):
        return arr @ self._A.T.to(arr.dtype)

    def adjoint(self, arr):
        return arr @ self._A.to(arr.dtype)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)).astype(np.float32)
    y = rng.standard_normal(M).astype(np.float32)
    x0 = rng.standard_normal(N).astype(np.float32)
    return A, y, x0


def _problems(lib, A, y):
    """(g = L1, h = L1, K) and (f = 1/2 ||K . - y||^2, g = L1), built
    from one package's operators."""
    if lib == "jax":
        K = JLinOp.from_array(jnp.asarray(A))
        l1, sq, arr = jfunc.L1Norm, jfunc.SquaredL2Norm, jnp.asarray
    else:
        K = _Dense(torch.from_numpy(A))
        l1, sq, arr = L1Norm, SquaredL2Norm, torch.from_numpy
    return {"g_h_K": dict(g=0.1 * l1((N,)), h=l1((M,)), K=K),
            "f_g": dict(f=0.5 * sq((M,)).asloss(arr(y)) * K,
                        g=0.1 * l1((N,)))}


@pytest.mark.parametrize("problem", ["g_h_K", "f_g"])
def test_condatvu_estimates_unknown_constants_like_jax(problem):
    A, y, x0 = _data()
    kw_t = _problems("torch", A, y)[problem]
    assert all(not math.isfinite(op.lipschitz) for op in kw_t.values()
               if isinstance(op, LinOp))
    slv = CondatVu(**kw_t, stop_rate=ITERS)
    slv.fit(x0=torch.from_numpy(x0), stop_crit=MaxIter(ITERS),
            max_iter=ITERS)

    kw_j = _problems("jax", A, y)[problem]
    slv_j = JCondatVu(**kw_j, stop_rate=ITERS)
    slv_j.fit(x0=jnp.asarray(x0), stop_crit=JMaxIter(ITERS), max_iter=ITERS)

    L = float(np.linalg.norm(A.astype(np.float64), 2))
    assert slv._tau == pytest.approx(slv_j._tau, rel=RTOL)
    assert slv._sigma == pytest.approx(slv_j._sigma, rel=RTOL)
    assert slv._rho == slv_j._rho == 1.0
    if problem == "g_h_K":      # beta = 0: tau = sigma = 1 / ||K||
        assert slv._tau == pytest.approx(1.0 / L, rel=RTOL)
    else:                       # beta = ||K||^2, no h: tau = 1 / beta
        assert slv._tau == pytest.approx(1.0 / L ** 2, rel=RTOL)
        assert slv._sigma == 0.0
    x = slv.solution().numpy()
    assert x.dtype == np.float32
    np.testing.assert_allclose(x, np.asarray(slv_j.solution()), rtol=0,
                               atol=ATOL)


def test_condatvu_estimates_on_the_state_dtype():
    """The estimate runs in x0's dtype: a float64 state gives ||K|| to
    float64 accuracy."""
    A, y, x0 = _data(1)
    kw = _problems("torch", A, y)["g_h_K"]
    slv = CondatVu(**kw)
    slv.m_init(x0=torch.from_numpy(x0.astype(np.float64)))
    L = float(np.linalg.norm(A.astype(np.float64), 2))
    assert slv._tau == pytest.approx(1.0 / L, rel=1e-9)
    assert kw["K"].lipschitz == pytest.approx(L, rel=1e-9)
