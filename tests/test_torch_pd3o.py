"""The port's indicator functionals, PD3O and the primal-dual
specialisations against pyxu_tpu, on the CPU.

One numpy input goes through both packages (the JAX side under
``jax.jit`` where it is called directly).  The solvers run the small
problems of ``tests/test_pds.py`` (a 20-sample signal, a forward
difference, lam = 0.4) for 30 iterations in float64; the difference's
norm is the JAX package's estimate, carried across, so both packages take
the same steps.  Tolerances: proxes 1e-10 relative, iterates atol 1e-8
(``atol_for`` at float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.opt.solver as jsolver
from pyxu_tpu.abc import LinOp as JLinOp
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.opt.solver as tsolver
from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.opt.stop import MaxIter

N, LAM, ITERS = 20, 0.4, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dense(LinOp):
    """x -> A x for a dense (M, N) matrix."""

    def __init__(self, A: torch.Tensor):
        super().__init__((A.shape[1],), (A.shape[0],))
        self._A = A

    def apply(self, arr):
        return arr @ self._A.T.to(arr.dtype)

    def adjoint(self, arr):
        return arr @ self._A.to(arr.dtype)


def _pkg(lib):
    """A package's functionals, a dense LinOp and an array constructor."""
    if lib == "jax":
        return jfunc, (lambda A: JLinOp.from_array(jnp.asarray(A))), \
            jnp.asarray
    return tfunc, (lambda A: _Dense(torch.from_numpy(A))), torch.from_numpy


# ------------------------------------------------------------ indicators ---

def _indicator(lib, name):
    """The indicator ``name`` and its domain shape, from one package."""
    F, dense, arr = _pkg(lib)
    rng = np.random.default_rng(7)
    A_tall, A_wide = rng.standard_normal((6, 3)), rng.standard_normal((3, 6))
    b, a = rng.standard_normal(3), rng.standard_normal((4, 5))
    sets = {
        "L1Ball": lambda: F.L1Ball((4, 5), radius=2.0),
        "L2Ball": lambda: F.L2Ball((4, 5), radius=1.5),
        "LInfinityBall": lambda: F.LInfinityBall((4, 5), radius=0.5),
        "PositiveOrthant": lambda: F.PositiveOrthant((4, 5)),
        "HyperSlab": lambda: F.HyperSlab(arr(a), -1.0, 2.0),
        "RangeSet": lambda: F.RangeSet(dense(A_tall)),
        "AffineSet": lambda: F.AffineSet(dense(A_wide), arr(b)),
        "ConvexSetIntersection": lambda: F.ConvexSetIntersection(
            F.L2Ball((4, 5), radius=1.5), F.PositiveOrthant((4, 5))),
    }
    return sets[name]()


@pytest.mark.parametrize("name", [
    "L1Ball", "L2Ball", "LInfinityBall", "PositiveOrthant", "HyperSlab",
    "RangeSet", "AffineSet", "ConvexSetIntersection"])
def test_indicator_matches_jax(name):
    """Membership (0 or inf) of a batch of points inside and outside the
    set, and the prox (the projection), which lands in the set."""
    jf, tf = _indicator("jax", name), _indicator("torch", name)
    assert tf.dim_shape == jf.dim_shape
    rng = np.random.default_rng(8)
    x = 2.0 * rng.standard_normal((3,) + tf.dim_shape)
    want = np.asarray(jax.jit(lambda v: jf.prox(v, 1.0))(jnp.asarray(x)))
    got = tf.prox(torch.from_numpy(x), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * float(np.abs(want).max()))
    pts = np.concatenate([x, want])
    jval = np.asarray(jax.jit(jf.apply)(jnp.asarray(pts)))
    tval = tf.apply(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(tval, jval)
    assert np.all(tval[3:] == 0)


# --------------------------------------------------------------- solvers ---

def _signal():
    rng = np.random.default_rng(41)
    return np.clip(rng.standard_normal(N).cumsum(), -2, 2)


def _diff():
    return np.eye(N, k=1)[: N - 1] - np.eye(N)[: N - 1]


def _solver(lib, name, L_diff):
    """One of the problems of tests/test_pds.py, as a solver of ``lib``
    and its x0."""
    F, dense, arr = _pkg(lib)
    S, kw = (jsolver, {}) if lib == "jax" else (tsolver,
                                                 {"stop_rate": ITERS})
    y = _signal()
    f = 0.5 * F.SquaredL2Norm((N,)).asloss(arr(y))
    D = dense(_diff())
    D.lipschitz = L_diff
    h1 = LAM * F.L1Norm((N - 1,))
    l1 = LAM * F.L1Norm((N,))
    x0 = y if name == "ProximalPoint" else np.zeros(N)
    slv = {
        "PD3O": lambda: S.PD3O(f=f, h=h1, K=D, **kw),
        "PD3O-f-only": lambda: S.PD3O(f=f, **kw),
        "ChambollePock": lambda: S.ChambollePock(g=f, h=h1, K=D, **kw),
        "LorisVerhoeven": lambda: S.LorisVerhoeven(f=f, h=h1, K=D, **kw),
        "DavisYin": lambda: S.DavisYin(f=f, g=l1, h=l1, **kw),
        "DouglasRachford": lambda: S.DouglasRachford(g=f, h=l1, **kw),
        "ForwardBackward": lambda: S.ForwardBackward(f=f, g=l1, **kw),
        "ProximalPoint": lambda: S.ProximalPoint(g=l1, **kw),
    }[name]()
    return slv, arr(x0)


@pytest.mark.parametrize("name", [
    "PD3O", "PD3O-f-only", "ChambollePock", "LorisVerhoeven", "DavisYin",
    "DouglasRachford", "ForwardBackward", "ProximalPoint"])
def test_pd3o_family_matches_jax(name):
    jD = JLinOp.from_array(jnp.asarray(_diff()))
    L = float(jD.estimate_lipschitz())
    jslv, jx0 = _solver("jax", name, L)
    jslv.fit(x0=jx0, stop_crit=JMaxIter(ITERS), max_iter=ITERS)
    want = np.asarray(jslv.solution())
    slv, x0 = _solver("torch", name, L)
    slv.fit(x0=x0, stop_crit=MaxIter(ITERS), max_iter=ITERS)
    got = slv.solution().numpy()
    assert type(slv).__name__ == type(jslv).__name__
    # the specialisations carry their own name, as in the JAX package
    assert getattr(slv, "_name", None) == getattr(jslv, "_name", None)
    assert (slv._tau, slv._sigma, slv._rho) == pytest.approx(
        (jslv._tau, jslv._sigma, jslv._rho), rel=1e-12)
    assert set(slv._mstate) == set(jslv._mstate)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(np.float64))
    # 30 iterations move the iterate away from x0
    assert float(np.abs(got - np.asarray(x0)).max()) > 1e-3


def test_solver_aliases():
    for short, long in (("CP", "ChambollePock"), ("LV", "LorisVerhoeven"),
                        ("DY", "DavisYin"), ("DR", "DouglasRachford"),
                        ("FB", "ForwardBackward"), ("PP", "ProximalPoint")):
        assert getattr(tsolver, short) is getattr(tsolver, long)
