"""The port's CG, quadratic prox, NUFFT Toeplitz gram and ADMM against
pyxu_tpu, on the CPU, and the radio-interferometry solve end to end.

One numpy problem goes through both packages (the JAX side under
``jax.jit`` where it is called directly).  Iterates agree within
``atol_for`` (2e-4 at f32, 1e-8 at f64).  ``tests/conftest.py`` turns on
x64 for the JAX package, so its float32 NUFFT grams are built to
``min(eps, 1e-9)`` while the port's float32 plan builds them at eps: the
float32 grams differ by about eps (1e-6 of their largest value), which the
float32 tolerances allow for.
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
from pyxu_tpu.math.cg import cg_solve as jcg_solve
from pyxu_tpu.models.workloads import radio_interferometry as jri
from pyxu_tpu.operator.linop.nufft import NUFFT as JNUFFT
from pyxu_tpu.opt.solver import ADMM as JADMM
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu_torch.abc.operator import DiffFunc
from pyxu_tpu_torch.convert import ri_problem
from pyxu_tpu_torch.math.cg import CHECK_RATE, cg_solve
from pyxu_tpu_torch.models import radio_interferometry
from pyxu_tpu_torch.operator.linop.nufft import NUFFT
from pyxu_tpu_torch.opt.solver import ADMM
from pyxu_tpu_torch.opt.stop import MaxIter, RelError

SHAPE, N_VIS = (32, 40), 600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tdt(fdtype):
    return torch.from_numpy(np.zeros(0, fdtype)).dtype


def _uv(n=N_VIS, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(0, np.pi / 3, (n, 2)).clip(-np.pi, np.pi)


# ------------------------------------------------------------------- CG ---

CG_CASES = {
    "converges-early": dict(maxiter=200),
    "five-steps": dict(maxiter=5),
    "jacobi-precond": dict(maxiter=8, precond=True),
    "restart": dict(maxiter=9, restart_rate=3),
    "atol": dict(maxiter=200, rtol=0.0, atol=1e-3),
}


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_cg_solve_matches_jax(case, fdtype):
    """Batched right-hand sides (3, 30) with core_ndim 1 and x0 given."""
    kw = dict(CG_CASES[case])
    rng = np.random.default_rng(6)
    B = rng.standard_normal((30, 30))
    A = (B @ B.T / 30 + 0.5 * np.eye(30)).astype(fdtype)
    b = rng.standard_normal((3, 30)).astype(fdtype)
    x0 = rng.standard_normal(30).astype(fdtype)
    d = np.diag(A).copy()
    pre = kw.pop("precond", False)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    got = cg_solve(lambda p: p @ At, torch.from_numpy(b),
                   torch.from_numpy(x0), core_ndim=1,
                   precond=(lambda r: r / torch.from_numpy(d)) if pre
                   else None, **kw).numpy()
    want = np.asarray(jax.jit(lambda bb, xx: jcg_solve(
        lambda p: p @ Aj, bb, xx, core_ndim=1,
        precond=(lambda r: r / jnp.asarray(d)) if pre else None,
        **kw))(jnp.asarray(b), jnp.asarray(x0)))
    assert got.dtype == fdtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(fdtype))
    if case == "converges-early":        # frozen once converged
        res = np.linalg.norm(got.astype(np.float64) @ A - b, axis=1)
        slack = 1.01 if fdtype == np.float64 else 100.0    # f32 roundoff
        assert np.all(res <= slack * 1e-6 * np.linalg.norm(b, axis=1))


def test_cg_solve_whole_array_and_no_host_reads(monkeypatch):
    """core_ndim None takes the whole array as one vector; a budget of at
    most CHECK_RATE iterations reads nothing back to the host."""
    rng = np.random.default_rng(7)
    A = np.diag(rng.uniform(1, 2, 12))
    b = rng.standard_normal((3, 4))
    got = cg_solve(lambda p: (p.reshape(-1) @ torch.from_numpy(A))
                   .reshape(3, 4), torch.from_numpy(b), maxiter=20)
    np.testing.assert_allclose(got.numpy().ravel(),
                               b.ravel() / np.diag(A), atol=1e-5)

    def read(*_):
        raise AssertionError("host read")
    for name in ("__bool__", "__float__", "__int__", "item", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)
    out = cg_solve(lambda p: 2 * p, torch.from_numpy(b), maxiter=CHECK_RATE)
    monkeypatch.undo()
    np.testing.assert_allclose(out.numpy(), b / 2, atol=1e-12)


# ------------------------------------------------- quadratic prox / grams ---

def _losses(real, fdtype):
    """0.5 ||A x - y||^2 with A a type-2 NUFFT, in both packages."""
    uv = _uv()
    y = np.random.default_rng(8).standard_normal((N_VIS, 2)).astype(fdtype)
    jA = JNUFFT.type2(uv, SHAPE, eps=1e-6, real=real)
    tA = NUFFT.type2(uv, SHAPE, eps=1e-6, real=real, dtype=_tdt(fdtype),
                     device="cpu")
    jf = 0.5 * jfunc.SquaredL2Norm((N_VIS, 2)).asloss(jnp.asarray(y)) * jA
    tf = 0.5 * tfunc.SquaredL2Norm((N_VIS, 2)).asloss(torch.from_numpy(y)) \
        * tA
    return jA, tA, jf, tf


@pytest.mark.parametrize("real,maxiter", [(True, None), (False, 3)])
def test_quadratic_prox_matches_jax(real, maxiter, fdtype):
    """The default budget (500 iterations at this size) and a short one."""
    jA, tA, jf, tf = _losses(real, fdtype)
    if maxiter is not None:
        jf._prox_maxiter = tf._prox_maxiter = maxiter
    x = np.random.default_rng(9).standard_normal(tA.dim_shape) \
        .astype(fdtype)
    want = np.asarray(jax.jit(lambda v: jf.prox(v, 0.05))(jnp.asarray(x)))
    got = tf.prox(torch.from_numpy(x), 0.05).numpy()
    assert got.dtype == fdtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_for(fdtype) * max(
                                   1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("real", [True, False])
def test_toeplitz_gram_matches_jax(real, fdtype):
    jA, tA, _, _ = _losses(real, fdtype)
    jG, tG = jA.gram(), tA.gram()
    assert type(tG).__name__ == "_NUFFTToeplitz" and tG._real_in == real
    x = np.random.default_rng(10).standard_normal((2,) + tA.dim_shape) \
        .astype(fdtype)
    want = np.asarray(jax.jit(jG.apply)(jnp.asarray(x)))
    got = tG.apply(torch.from_numpy(x)).numpy()
    direct = tA.adjoint(tA.apply(torch.from_numpy(x))).numpy()
    scale = float(np.abs(want).max())
    # float32: the JAX gram is built to 1e-9, the port's to eps = 1e-6
    rel = 5e-6 if fdtype == np.float32 else 1e-10
    assert float(np.abs(got - want).max()) <= rel * scale
    # against A^H A through spread and interp, at the plan's eps
    assert float(np.abs(got - direct).max()) <= 1e-5 * scale
    assert tG.trace() == jG.trace()
    assert tG.lipschitz == pytest.approx(jG.lipschitz, rel=1e-5)
    assert np.array_equal(tG.adjoint(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("real", [True, False])
def test_cogram_matches_jax(real):
    uv = _uv(400, seed=11)
    jop = JNUFFT.type1(uv, (24, 20), eps=1e-6, real=real)
    top = NUFFT.type1(uv, (24, 20), eps=1e-6, real=real,
                      dtype=torch.float64, device="cpu")
    jC, tC = jop.cogram(), top.cogram()
    assert (type(tC).__name__ == "_NUFFTToeplitz") == (not real)
    x = np.random.default_rng(12).standard_normal((24, 20, 2))
    want = np.asarray(jax.jit(jC.apply)(jnp.asarray(x)))
    got = tC.apply(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-10 * float(
        np.abs(want).max())


def test_quadratic_prox_default_budget_stops_early(monkeypatch):
    """A well-conditioned prox at its default budget (500 iterations at
    30x40) stops at the first convergence check after the JAX loop's exit,
    with the JAX package's result."""
    shape, fdtype = (30, 40), np.float32
    taps = [np.array([0.25, 0.5, 0.25], fdtype)] * 2
    y = np.random.default_rng(15).random(shape).astype(fdtype)
    x = np.random.default_rng(16).standard_normal(shape).astype(fdtype)
    jK = jlin.Stencil(shape, [jnp.asarray(t) for t in taps], [1, 1],
                      mode="symmetric")
    jf = 0.5 * jfunc.SquaredL2Norm(shape).asloss(jnp.asarray(y)) * jK
    tf = 0.5 * tfunc.SquaredL2Norm(shape).asloss(torch.from_numpy(y)) \
        * tlin.Stencil(shape, taps, [1, 1], mode="symmetric")
    Q = tf._quad_spec()[0]
    calls, apply = [], Q.apply
    monkeypatch.setattr(Q, "apply", lambda a: calls.append(1) or apply(a))
    want = np.asarray(jax.jit(lambda v: jf.prox(v, 0.5))(jnp.asarray(x)))
    got = tf.prox(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(fdtype))
    # I + Q/2 has condition <= 1.5: a few CG steps reach rtol, and the loop
    # stops at the first check (every CHECK_RATE steps) that finds it there
    assert len(calls) == 1 + CHECK_RATE, len(calls)


# ------------------------------------------------------------------ ADMM ---

class _JPseudoHuber(JDiffFunc):
    """sum(sqrt(1 + (x - y)^2)): differentiable, not quadratic, gradient
    Lipschitz 1."""

    def __init__(self, y):
        super().__init__(y.shape)
        self._y = jnp.asarray(y)
        self._diff_lipschitz = 1.0

    def apply(self, arr):
        d = arr - self._y
        return jnp.sum(jnp.sqrt(1.0 + d * d), axis=(-2, -1))

    def grad(self, arr):
        d = arr - self._y
        return d / jnp.sqrt(1.0 + d * d)


class _TPseudoHuber(DiffFunc):

    def __init__(self, y):
        super().__init__(y.shape)
        self._y = torch.from_numpy(y)
        self._diff_lipschitz = 1.0

    def apply(self, arr):
        d = arr - self._y
        return torch.sum(torch.sqrt(1.0 + d * d), dim=(-2, -1))

    def grad(self, arr):
        d = arr - self._y
        return d / torch.sqrt(1.0 + d * d)


def _admm_pair(branch, fdtype):
    """The same ADMM problem in both packages, for one x-update branch."""
    shape = (20, 24)
    y = np.random.default_rng(13).random(shape).astype(fdtype)
    if branch == "prox":            # K = None, quadratic f: f.prox (CG)
        taps = [np.array([0.25, 0.5, 0.25], fdtype)] * 2
        jK = jlin.Stencil(shape, [jnp.asarray(t) for t in taps], [1, 1],
                          mode="symmetric")
        tK = tlin.Stencil(shape, taps, [1, 1], mode="symmetric")
        jf = 0.5 * jfunc.SquaredL2Norm(shape).asloss(jnp.asarray(y)) * jK
        tf = 0.5 * tfunc.SquaredL2Norm(shape).asloss(torch.from_numpy(y)) \
            * tK
        kw = [dict(f=jf, h=0.05 * jfunc.L1Norm(shape)),
              dict(f=tf, h=0.05 * tfunc.L1Norm(shape))]
    else:
        jD = jlin.Gradient(shape, mode="symmetric")
        tD = tlin.Gradient(shape, mode="symmetric")
        if branch == "cg":          # K given, quadratic f: nested CG
            jf = jfunc.SquaredL2Norm(shape).asloss(jnp.asarray(y))
            tf = tfunc.SquaredL2Norm(shape).asloss(torch.from_numpy(y))
        else:                       # K given, f differentiable: GD steps
            jf, tf = _JPseudoHuber(3 * y), _TPseudoHuber(3 * y)
        kw = [dict(f=jf, K=jD, h=0.1 * jfunc.L21Norm((2,) + shape,
                                                      l2_axis=0)),
              dict(f=tf, K=tD, h=0.1 * tfunc.L21Norm((2,) + shape,
                                                      l2_axis=0))]
    sk = dict(maxiter=4)
    return (JADMM(solver_kwargs=sk, **kw[0]),
            ADMM(solver_kwargs=sk, stop_rate=5, **kw[1]), shape)


# each branch at float32; the nested CG at float64 too (the prox branch
# runs at float64 in test_ri_solve_matches_jax)
@pytest.mark.parametrize("branch,fdtype", [
    ("prox", np.float32), ("cg", np.float32), ("cg", np.float64),
    ("gd", np.float32)])
def test_admm_matches_jax(branch, fdtype):
    jslv, tslv, shape = _admm_pair(branch, fdtype)
    x0 = np.zeros(shape, fdtype)
    jslv.fit(x0=jnp.asarray(x0), tau=0.5, stop_crit=JMaxIter(15),
             max_iter=15)
    tslv.fit(x0=torch.from_numpy(x0), tau=0.5, stop_crit=MaxIter(15),
             max_iter=15)
    want = np.asarray(jslv.solution())
    got = tslv.solution().numpy()
    assert got.dtype == fdtype and bool(np.any(got != 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(fdtype))
    for k in ("z", "u"):
        np.testing.assert_allclose(tslv._mstate[k].numpy(),
                                   np.asarray(jslv._mstate[k]), rtol=0,
                                   atol=atol_for(fdtype))
    assert float(tslv.objective_func(tslv._mstate)) == pytest.approx(
        float(jslv.objective_func(jslv._mstate)), rel=1e-5)
    if branch == "gd":
        assert tslv._gd_step == pytest.approx(jslv._gd_step, rel=1e-12)
    if branch == "prox":            # the caller's f keeps its settings
        assert tslv._f._prox_maxiter == 4
        assert getattr(tslv._f, "_prox_rtol") is None
    assert isinstance(tslv.default_stop_crit(), RelError)
    assert list(tslv.stats()[1]["iteration"]) == [5, 10, 15]


def test_admm_keeps_the_callers_f():
    """solver_kwargs go to a private copy of a quadratic f."""
    shape = (6, 5)
    f = 0.5 * tfunc.SquaredL2Norm(shape).asloss(
        torch.ones(shape, dtype=torch.float64))
    h = 0.05 * tfunc.L1Norm(shape)
    slv = ADMM(f=f, h=h, solver_kwargs=dict(maxiter=4, rtol=1e-3))
    assert slv._f is not f
    assert (slv._f._prox_maxiter, slv._f._prox_rtol) == (4, 1e-3)
    assert (f._prox_maxiter, f._prox_rtol) == (None, None)
    assert ADMM(f=f, h=h)._f is f
    with pytest.raises(ValueError):
        ADMM(f=tfunc.L1Norm(shape), h=tfunc.L1Norm((2,) + shape),
             K=tlin.Gradient(shape))


# ------------------------------------------------------ the RI workload ---

@pytest.mark.parametrize("real_sky", [True, False])
def test_ri_solve_matches_jax(real_sky):
    """``convert.ri_problem`` takes the problem's numpy uv and y; 20 ADMM
    iterations (inner CG of 3) agree with the JAX package's within
    atol_for, at float64 (float32: test_ri_factory_matches_jax)."""
    uv = _uv(seed=14).astype(np.float32)
    dom = SHAPE if real_sky else SHAPE + (2,)
    x_true = np.zeros(dom)
    x_true[(3, 17, 25), (5, 30, 11), ...] = np.array(
        [0.7, 0.4, 0.9]).reshape((3,) + (1,) * (len(dom) - 2)) \
        * np.array([1.0, 0.0][: 1 if real_sky else 2])
    A = NUFFT.type2(uv, SHAPE, eps=1e-6, real=real_sky, dtype=torch.float64,
                    device="cpu")
    y = A.apply(torch.from_numpy(x_true)).numpy()
    jA = JNUFFT.type2(uv, SHAPE, eps=1e-6, real=real_sky)
    jf = 0.5 * jfunc.SquaredL2Norm((N_VIS, 2)).asloss(jnp.asarray(y)) * jA
    jslv = JADMM(f=jf, h=0.02 * jfunc.L1Norm(dom),
                 solver_kwargs=dict(maxiter=3))
    jslv.fit(x0=jnp.zeros(dom), tau=0.05, stop_crit=JMaxIter(20),
             max_iter=20)
    want = np.asarray(jslv.solution())
    *_, slv, fit = ri_problem(uv, y, SHAPE, real_sky=real_sky, device="cpu",
                              stop_rate=10)
    slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
    got = slv.solution().numpy()
    assert got.dtype == np.float64 and got.shape == dom
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(np.float64))
    assert float(slv.objective_func(slv._mstate)) == pytest.approx(
        float(jslv.objective_func(jslv._mstate)), rel=1e-6)


@pytest.mark.parametrize("real_sky", [True, False])
def test_ri_factory_matches_jax(real_sky):
    """The factories draw the same problem from one seed; 20 iterations of
    the port's float32 solve agree with the JAX package's."""
    jslv, jfit, jex = jri(shape=SHAPE, n_vis=N_VIS, real_sky=real_sky)
    jslv.fit(stop_crit=JMaxIter(20), max_iter=20, **jfit)
    slv, fit, ex = radio_interferometry(SHAPE, n_vis=N_VIS, device="cpu",
                                        real_sky=real_sky, stop_rate=10)
    slv.fit(stop_crit=MaxIter(20), max_iter=20, **fit)
    got = slv.solution().numpy()
    obj0 = float(slv.objective_func({"x": fit["x0"]}))
    obj = float(slv.objective_func(slv._mstate))
    np.testing.assert_array_equal(ex["x_true"], np.asarray(jex["x_true"]))
    np.testing.assert_allclose(ex["y"].numpy(), np.asarray(jex["y"]),
                               rtol=0, atol=1e-5 * float(
                                   np.abs(np.asarray(jex["y"])).max()))
    assert ex["A"].kernel_path == "kernel"
    assert fit["tau"] == jfit["tau"] and fit["x0"].dtype == torch.float32
    assert slv._f._prox_maxiter == 3
    # 32 power steps from other random starts, below the circulant bound
    assert ex["A"].lipschitz == pytest.approx(jex["A"].lipschitz, rel=1e-2)
    assert ex["A"].lipschitz <= np.sqrt(ex["A"].gram().lipschitz)
    np.testing.assert_allclose(got, np.asarray(jslv.solution()), rtol=0,
                               atol=atol_for(np.float32))
    assert obj < obj0
