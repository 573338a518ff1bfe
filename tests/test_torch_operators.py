"""The port's operators of the TV path against pyxu_tpu, on the CPU.

One numpy input goes through both packages; outputs agree within
``atol_for`` (2e-4 at f32, 1e-8 at f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for
from test_torch_kernels import _gauss

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.opt.solver import CondatVu as JCondatVu
from pyxu_tpu_torch.abc.arithmetic import CastMixin, ChainMixin
from pyxu_tpu_torch.abc.operator import LinFunc, QuadraticFunc, _GramOp
from pyxu_tpu_torch.opt.solver import CondatVu as TCondatVu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W = 13, 11


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(j, t, dtype):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=atol_for(dtype))


def _dot_test(op, rng, dtype):
    x = torch.from_numpy(rng.standard_normal(op.dim_shape).astype(dtype))
    y = torch.from_numpy(rng.standard_normal(op.codim_shape).astype(dtype))
    lhs = float(torch.sum(op.apply(x) * y))
    rhs = float(torch.sum(x * op.adjoint(y)))
    assert abs(lhs - rhs) <= 10 * atol_for(dtype) * max(1.0, abs(lhs))


def _jit_apply_adjoint(jop, x, y):
    """``(jop.apply(x), jop.adjoint(y))`` under one ``jax.jit`` (eager JAX
    compiles op by op)."""
    return jax.jit(lambda a, b: (jop.apply(a), jop.adjoint(b)))(x, y)


@pytest.mark.parametrize("mode",
                         ["constant", "wrap", "reflect", "symmetric", "edge"])
def test_pad_apply_adjoint(mode, rng, fdtype):
    pw = ((2, 3), (1, 0))
    jop, top = jlin.Pad((H, W), pw, mode=mode), tlin.Pad((H, W), pw, mode=mode)
    xj, xt = _both(rng.standard_normal((2, H, W)).astype(fdtype))
    yj, yt = _both(rng.standard_normal((2,) + top.codim_shape).astype(fdtype))
    wa, wb = _jit_apply_adjoint(jop, xj, yj)
    _close(wa, top.apply(xt), fdtype)
    _close(wb, top.adjoint(yt), fdtype)
    assert top.lipschitz == pytest.approx(jop.lipschitz, rel=1e-12)
    _dot_test(top, rng, fdtype)


_STENCILS = {
    "gauss9": ([_gauss(), _gauss()], [4, 4]),
    "asym": ([np.array([0.2, 0.5, 0.3], np.float32),
              np.array([0.1, 0.6, 0.2, 0.1], np.float32)], [1, 2]),
    "full3x3": (np.arange(9, dtype=np.float32).reshape(3, 3) / 10, (0, 2)),
}


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("name", sorted(_STENCILS))
def test_stencil_apply_adjoint(name, mode, rng, fdtype):
    kern, ctr = _STENCILS[name]
    jk = [jnp.asarray(k) for k in kern] if isinstance(kern, list) \
        else jnp.asarray(kern)
    jop = jlin.Stencil((H, W), jk, ctr, mode=mode)
    top = tlin.Stencil((H, W), kern, ctr, mode=mode)
    xj, xt = _both(rng.standard_normal((H, W)).astype(fdtype))
    wa, wb = _jit_apply_adjoint(jop, xj, xj)
    _close(wa, top.apply(xt), fdtype)
    _close(wb, top.adjoint(xt), fdtype)
    assert top.lipschitz == pytest.approx(jop.lipschitz, rel=1e-6)
    _dot_test(top, rng, fdtype)


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
def test_gradient_apply_adjoint(mode, rng, fdtype):
    jop, top = jlin.Gradient((H, W), mode=mode), tlin.Gradient((H, W), mode=mode)
    xj, xt = _both(rng.standard_normal((3, H, W)).astype(fdtype))
    yj, yt = _both(rng.standard_normal((2, H, W)).astype(fdtype))
    wa, wb = _jit_apply_adjoint(jop, xj, yj)
    _close(wa, top.apply(xt), fdtype)
    _close(wb, top.adjoint(yt), fdtype)
    assert top.lipschitz == pytest.approx(jop.lipschitz, rel=1e-12)
    _dot_test(top, rng, fdtype)


def test_norms_apply_prox_fenchel(rng, fdtype):
    lam, tau = 0.3, 0.7
    cases = [
        (jfunc.SquaredL2Norm((H, W)), tfunc.SquaredL2Norm((H, W)), (H, W)),
        (jfunc.L1Norm((H, W)), tfunc.L1Norm((H, W)), (H, W)),
        (lam * jfunc.L21Norm((2, H, W), l2_axis=0),
         lam * tfunc.L21Norm((2, H, W), l2_axis=0), (2, H, W)),
    ]
    xs = [rng.standard_normal((3,) + shape).astype(fdtype)
          for _, _, shape in cases]
    want = jax.jit(lambda *v: [                 # one compile for the three
        (jf.apply(a), jf.prox(a, tau), jf.fenchel_prox(a, tau))
        for (jf, _, _), a in zip(cases, v)])(*xs)
    for (_, tf, _), x, (wa, wp, wf) in zip(cases, xs, want):
        xt = torch.from_numpy(x)
        _close(wa, tf.apply(xt), fdtype)
        _close(wp, tf.prox(xt, tau), fdtype)
        _close(wf, tf.fenchel_prox(xt, tau), fdtype)


def _data_terms(rng, dtype, mode="symmetric"):
    y = rng.random((H, W)).astype(dtype)
    k = _gauss()
    Kj = jlin.Stencil((H, W), [jnp.asarray(k)] * 2, [4, 4], mode=mode)
    Kt = tlin.Stencil((H, W), [k, k], [4, 4], mode=mode)
    fj = 0.5 * jfunc.SquaredL2Norm((H, W)).asloss(jnp.asarray(y)) * Kj
    ft = 0.5 * tfunc.SquaredL2Norm((H, W)).asloss(torch.from_numpy(y)) * Kt
    return fj, ft, Kt


def test_data_term_structure_and_grad(rng, fdtype):
    fj, ft, Kt = _data_terms(rng, fdtype)
    # the rule engine's quadratic over the Gram of the blur
    assert type(ft) is QuadraticFunc
    Q, c, t = ft._quad_spec()
    assert isinstance(Q, CastMixin) and isinstance(Q._op, _GramOp)
    assert Q._op._op is Kt
    assert isinstance(c, ChainMixin) and isinstance(c, LinFunc)
    xj, xt = _both(rng.standard_normal((H, W)).astype(fdtype))
    wg, wa = jax.jit(lambda a: (fj.grad(a), fj.apply(a)))(xj)
    _close(wg, ft.grad(xt), fdtype)
    _close(wa, ft.apply(xt), fdtype)
    # constant-gradient cache of the linear term
    assert c.grad(xt) is not None and len(c._cgrad_w) == 1


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_lipschitz_and_step_sizes(strategy, rng, fdtype):
    fj, ft, _ = _data_terms(rng, fdtype)
    jD, tD = jlin.Gradient((H, W), mode="symmetric"), \
        tlin.Gradient((H, W), mode="symmetric")
    hj = 0.01 * jfunc.L21Norm((2, H, W), l2_axis=0)
    ht = 0.01 * tfunc.L21Norm((2, H, W), l2_axis=0)
    assert ft.diff_lipschitz == pytest.approx(fj.diff_lipschitz, rel=1e-6)
    assert tD.lipschitz == pytest.approx(jD.lipschitz, rel=1e-12)
    sj, st = JCondatVu(f=fj, h=hj, K=jD), TCondatVu(f=ft, h=ht, K=tD)
    x0 = rng.random((H, W)).astype(fdtype)
    sj.m_init(x0=jnp.asarray(x0), tuning_strategy=strategy)
    st.m_init(x0=torch.from_numpy(x0), tuning_strategy=strategy)
    # the blur's l1 norm is summed in f32 by both packages, in another order
    for name in ("_tau", "_sigma", "_rho"):
        assert getattr(st, name) == pytest.approx(getattr(sj, name), rel=1e-6)


@pytest.mark.parametrize("name", ["SINGLE", "DOUBLE"])
def test_precision_policy_matches_jax(name):
    from pyxu_tpu.info import dtypes as jdt
    from pyxu_tpu_torch.info import dtypes as tdt
    jw, tw = jdt.Width[name], tdt.Width[name]
    assert tw.eps == jw.eps
    assert tdt.atol_for(tw.value) == jdt.atol_for(jw.value)
    assert tdt.getPrecision() is tdt.Width.SINGLE
    with tdt.Precision(tw):
        assert tdt.getPrecision() is tw
        assert tdt.default_fdtype() == tw.value
        assert torch.zeros(0, dtype=tdt.default_fdtype()).numpy().dtype \
            == jdt.Width[name].value
    assert tdt.default_fdtype() == torch.float32
