"""Autodiff through the port's stencil and NUFFT wrappers, on the CPU.

Each wrapper (``ops/stencil.py`` ``separable_correlate2d`` and its
per-member form, ``ops/nufft.py`` spread and interp at d = 2, 3) carries a
``torch.autograd.Function`` whose VJP is the adjoint launch, whose JVP is
the launch on the tangent and whose ``vmap`` rule folds the mapped axis
into the batch.  Here their CPU paths (the plain versions) are held to
``gradcheck`` in float64 and to the plain version's own graph and a loop;
then the compositions that reach them (``grad`` through the rule engine's
autograd fallback, ``jacobian`` by JVP and VJP, ``from_torch`` /
``from_source``, a generic adjoint) against the JAX package on one numpy
input (float64, 1e-9 of max|ref|; the NUFFT within its plan's eps); and
the fused TV step's wrapper, which still refuses.  The plain 2-byte
stencils against the JAX Stencil are held in ``tests/test_torch_dtypes.py``
(``test_narrow_plain_stencil_matches_jax``).  The JAX side runs under one
``jax.jit``; torch on one thread.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.abc as jabc
import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu.operator.linop.nufft as jnu
import pyxu_tpu.operator.map.ufunc as jfn
import pyxu_tpu_torch.abc as tabc
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.interop as tint
import pyxu_tpu_torch.operator.linop as tlin
import pyxu_tpu_torch.operator.linop.nufft as tnu
import pyxu_tpu_torch.operator.map.ufunc as tfn
from pyxu_tpu.operator.interop.source import from_source as j_source
from pyxu_tpu_torch.operator.interop.source import from_source as t_source
from pyxu_tpu_torch.ops import fused_tv as ft
from pyxu_tpu_torch.ops import nufft as nu
from pyxu_tpu_torch.ops import stencil as st


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (32, 48)
STEP = (17, 23)          # gradcheck's shape


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gauss(n=9, sig=2.0):
    k = np.exp(-0.5 * ((np.arange(n) - (n - 1) / 2) / sig) ** 2)
    return k / k.sum()


def _sep(mode, seed=1):
    """Asymmetric off-centre taps: 4 rows (centre 3), 3 columns (0)."""
    rng = np.random.default_rng(seed)
    return st.SepTaps(k0=tuple(rng.standard_normal(4)), c0=3,
                      k1=tuple(rng.standard_normal(3)), c1=0, mode=mode)


def _members(mode):
    return st.MemberTaps([_sep(mode, seed=s) for s in (1, 2, 3)])


def _plans():
    """Plans of 64 points on a 32^2 and a 16^3 grid, float64, w = 6."""
    rng = np.random.default_rng(7)
    out = {}
    for d, nf in ((2, (32, 32)), (3, (16, 16, 16))):
        pts = _t(rng.uniform(0.0, 2 * math.pi, (64, d)))
        out[d] = (nu.plan2 if d == 2 else nu.plan3)(pts, nf, 6, 13.8,
                                                   torch.float64)
    return out


PLANS = _plans()
NU = {(2, True): nu.nufft_spread2, (2, False): nu.nufft_interp2,
      (3, True): nu.nufft_spread3, (3, False): nu.nufft_interp3}


def _nu_input(d, spread, lead=(2,), seed=0):
    plan = PLANS[d]
    core = (plan.M, 2) if spread else plan.nf + (2,)
    return _t(np.random.default_rng(seed).standard_normal(lead + core))


def _plain_fn(fn):
    """``fn`` with the wrappers' rules off: autograd through the plain
    versions' own graph."""
    def run(*a, **k):
        mp = pytest.MonkeyPatch()
        for mod in (st, nu):
            mp.setattr(mod, "under_autodiff", lambda *t: False)
        try:
            return fn(*a, **k)
        finally:
            mp.undo()
    return run


# ---------------------------------------------------------- the rules --

@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
def test_stencil_rule_gradcheck(mode, adjoint):
    """VJP (the flipped launch) and JVP of the stencil rule, float64."""
    p = _sep(mode)
    x = _t(np.random.default_rng(0).standard_normal((2,) + STEP))
    calls = st.separable_correlate2d.rule_calls
    c0 = dict(calls)
    assert torch.autograd.gradcheck(
        lambda t: st.separable_correlate2d(t, p, adjoint),
        (x.requires_grad_(True),), check_forward_ad=True)
    assert calls["vjp"] > c0.get("vjp", 0)
    assert calls["jvp"] > c0.get("jvp", 0)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("adjoint", [False, True])
def test_members_rule_gradcheck(adjoint, shared):
    """The per-member rule, a block-diagonal batch and a shared input
    (whose VJP sums the members' adjoints), float64."""
    mt = _members("symmetric")
    shape = (2,) + STEP if shared else (2, 3) + STEP
    x = _t(np.random.default_rng(1).standard_normal(shape))
    calls = st.separable_correlate2d_members.rule_calls
    c0 = calls["vjp"]
    assert torch.autograd.gradcheck(
        lambda t: st.separable_correlate2d_members(t, mt, adjoint, shared),
        (x.requires_grad_(True),), check_forward_ad=True, fast_mode=True)
    assert calls["vjp"] > c0


@pytest.mark.parametrize("spread", [True, False], ids=["spread", "interp"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_rule_gradcheck(d, spread):
    """Spread's VJP is interp on the same plan and interp's is spread,
    64 points on a 32^2 and a 16^3 grid, float64."""
    fn, plan = NU[d, spread], PLANS[d]
    a = _nu_input(d, spread, lead=(1,))
    c0 = fn.rule_calls["vjp"]
    assert torch.autograd.gradcheck(lambda t: fn(t, plan),
                                    (a.requires_grad_(True),),
                                    check_forward_ad=True, fast_mode=True)
    assert fn.rule_calls["vjp"] > c0


def _jvp_vjp(fn, x, v, w):
    """JVP at ``x`` along ``v`` and VJP of ``w``."""
    _, jv = torch.func.jvp(fn, (x,), (v,))
    _, vjp = torch.func.vjp(fn, x)
    return jv, vjp(w)[0]


@pytest.mark.parametrize("kind", ["single", "members", "shared", "spread2",
                                  "interp2", "spread3", "interp3"])
def test_jvp_vjp_vmap_rules_match_the_plain_graph(kind):
    """``torch.func.jvp``/``vjp`` through each rule against the plain
    versions' own graph, and ``vmap`` (over an axis that is not the first)
    against a loop."""
    rng = np.random.default_rng(3)
    if kind.startswith(("spread", "interp")):
        d, spread = int(kind[-1]), kind.startswith("spread")
        plan = PLANS[d]

        def fn(t):
            return NU[d, spread](t, plan)
        x = _nu_input(d, spread, seed=1)
        w = fn(x).clone().normal_(generator=torch.Generator().manual_seed(2))
        counter = NU[d, spread].rule_calls
    else:
        mt, shared = _members("constant"), kind == "shared"
        shape = (2, 3) + STEP if kind == "members" else (2,) + STEP
        if kind == "single":
            p = _sep("symmetric")

            def fn(t):
                return st.separable_correlate2d(t, p, True)
            counter = st.separable_correlate2d.rule_calls
        else:
            def fn(t):
                return st.separable_correlate2d_members(t, mt, False, shared)
            counter = st.separable_correlate2d_members.rule_calls
        x = _t(rng.standard_normal(shape))
        w = _t(rng.standard_normal(tuple(fn(x).shape)))
    v = _t(rng.standard_normal(tuple(x.shape)))
    c0 = dict(counter)
    got = _jvp_vjp(fn, x, v, w) + (
        torch.func.vmap(fn, in_dims=1)(torch.stack([v, 2 * v, -v], dim=1)),)
    assert all(counter[k] > c0.get(k, 0) for k in ("jvp", "vjp", "vmap"))
    want = _plain_fn(_jvp_vjp)(fn, x, v, w) + (
        torch.stack([fn(c * v) for c in (1, 2, -1)]),)
    for g, ref in zip(got, want):
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-12 * max(
            1.0, float(ref.abs().max())))


def test_nufft_empty_plan_differentiates_to_zeros():
    """M = 0: no launch either way; the backward of a spread is an empty
    interp, that of an interp a zero spread."""
    plan = nu.plan2(torch.zeros((0, 2), dtype=torch.float64), (16, 16), 6,
                    13.8, torch.float64)
    c = torch.zeros((1, 0, 2), dtype=torch.float64, requires_grad=True)
    nu.nufft_spread2(c, plan).sum().backward()
    assert c.grad.shape == (1, 0, 2)
    g = torch.ones((1, 16, 16, 2), dtype=torch.float64, requires_grad=True)
    nu.nufft_interp2(g, plan).sum().backward()
    assert g.grad.shape == g.shape and not g.grad.any()


def test_under_autodiff_sees_every_transform():
    """The wrappers' test: a recording graph, a ``torch.func`` transform
    and a ``forward_ad`` tangent each say yes; a plain tensor, one that
    requires grad under ``no_grad``, and a tensor without a tangent inside
    a ``dual_level`` say no."""
    from torch.autograd import forward_ad

    from pyxu_tpu_torch.ops._guard import under_autodiff
    x = torch.zeros(3)
    assert not under_autodiff(x)
    xr = x.clone().requires_grad_(True)
    assert under_autodiff(xr) and under_autodiff(x, xr)
    with torch.no_grad():
        assert not under_autodiff(xr)
    seen = []
    torch.func.vmap(lambda t: seen.append(under_autodiff(t)) or t)(
        torch.zeros(2, 3))
    torch.func.jvp(lambda t: seen.append(under_autodiff(t)) or t, (x,), (x,))
    assert seen == [True, True]
    with forward_ad.dual_level():
        assert under_autodiff(forward_ad.make_dual(x, torch.ones(3)))
        assert not under_autodiff(x)


def test_tv_step_still_refuses():
    """The fused TV step has no autograd rule (the JAX package does not
    differentiate its Pallas step either): off the CPU its wrapper raises
    under a recording graph and under ``torch.func`` (meta tensors stand in
    for the card's), and launches nothing."""
    p = ft.TVParams(k0=tuple(_gauss()), k1=tuple(_gauss()), c0=4, c1=4,
                    cst=1.0, lam=0.01, tau=0.1, sigma=0.1, rho=1.0)
    x = torch.zeros((24, 24), device="meta", requires_grad=True)
    z = torch.zeros((2, 24, 24), device="meta")
    n0 = (ft.tv_step.launches, ft.tv_stepk.launches)
    with pytest.raises(ValueError, match="no autograd rule"):
        ft.tv_step(x, z, x.detach(), p)
    with pytest.raises(ValueError, match="no autograd rule"):
        torch.func.vjp(lambda t: ft.tv_stepk(t, z, t, p, 2)[0], x.detach())
    assert (ft.tv_step.launches, ft.tv_stepk.launches) == n0


# ------------------------------------------- compositions against JAX --

def _problem(pkg):
    """(K, loss, Exp, Sigmoid) at SHAPE, float64: the 9-tap sigma = 2 blur
    (symmetric mode, the kernel path in the port) and
    ``SquaredL2Norm.asloss(y)``."""
    k = _gauss()
    y = np.random.default_rng(5).standard_normal(SHAPE)
    if pkg == "jax":
        K = jlin.Stencil(SHAPE, [jnp.asarray(k)] * 2, [4, 4],
                         mode="symmetric")
        return (K, jfunc.SquaredL2Norm(SHAPE).asloss(jnp.asarray(y)),
                jfn.Exp(SHAPE), jfn.Sigmoid(SHAPE))
    K = tlin.Stencil(SHAPE, [k, k], [4, 4], mode="symmetric")
    assert K.kernel_path == "kernel"
    return (K, tfunc.SquaredL2Norm(SHAPE).asloss(_t(y)), tfn.Exp(SHAPE),
            tfn.Sigmoid(SHAPE))


def _compositions(pkg, ops, x, v, w):
    K, loss, E, S = ops
    src = j_source if pkg == "jax" else t_source
    abc = jabc if pkg == "jax" else tabc
    sig = jax.nn.sigmoid if pkg == "jax" else torch.sigmoid
    norm = (jfunc if pkg == "jax" else tfunc).SquaredL2Norm(SHAPE)
    out = {
        "loss*(K*Exp)": (loss * (K * E)).grad(x),
        "loss*(K*Sigmoid)": (loss * (K * S)).grad(x),
        "SquaredL2*(K*Sigmoid+Sigmoid)": (norm * (K * S + S)).grad(x),
    }
    J = (S * K).jacobian(x)
    out["(Sigmoid*K).jacobian"] = (J.apply(v), J.adjoint(w))
    # a DiffMap from plain callables: its jacobian is a JVP and a VJP
    D = src(abc.DiffMap, SHAPE, SHAPE, apply=lambda t: sig(K.apply(t)))
    JD = D.jacobian(x)
    out["source DiffMap jacobian"] = (JD.apply(v), JD.adjoint(w))
    f = src(abc.DiffFunc, SHAPE, (),
            apply=lambda t: (K.apply(t) ** 2).sum((-2, -1)))
    out["source DiffFunc grad"] = f.grad(x)
    return out


def _jax_compositions(x, v, w):
    ops = _problem("jax")
    return jax.jit(lambda a, b, c: _compositions("jax", ops, a, b, c))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(w))


def test_compositions_reaching_the_stencil_match_jax():
    """grad through the rule engine's autograd fallback, the jacobian of a
    chain and of a DiffMap from callables, a DiffFunc from callables and
    one from ``from_torch``, and a ``from_torch`` LinOp's generic adjoint:
    each reaches the stencil wrapper's rule, and each gives the JAX
    package's numbers (float64, 1e-9 of max|ref|)."""
    rng = np.random.default_rng(6)
    x, v, w = (0.3 * rng.standard_normal(SHAPE) for _ in range(3))
    want = _jax_compositions(x, v, w)
    calls = st.separable_correlate2d.rule_calls
    c0 = dict(calls)
    ops = _problem("torch")
    got = _compositions("torch", ops, _t(x), _t(v), _t(w))
    assert calls["vjp"] > c0.get("vjp", 0) and calls["jvp"] > c0.get("jvp", 0)
    K, Kj = ops[0], _problem("jax")[0]
    g = tint.from_torch(tabc.DiffFunc, SHAPE,
                        apply=lambda t: (K.apply(t) ** 2).sum((-2, -1)))
    got["from_torch DiffFunc grad"] = g.grad(_t(x))
    want["from_torch DiffFunc grad"] = want["source DiffFunc grad"]
    A = tint.from_torch(tabc.LinOp, SHAPE, SHAPE, apply=K.apply)
    got["from_torch LinOp adjoint"] = A.adjoint(_t(w))
    want["from_torch LinOp adjoint"] = Kj.adjoint(jnp.asarray(w))
    assert set(got) == set(want)
    for name in got:
        gs = got[name] if isinstance(got[name], tuple) else (got[name],)
        ws = want[name] if isinstance(want[name], tuple) else (want[name],)
        for a, b in zip(gs, ws):
            b = np.asarray(b)
            err = float(np.abs(a.detach().numpy() - b).max())
            assert err <= 1e-9 * float(np.abs(b).max()), (name, err)


def test_nufft_composition_matches_jax():
    """``(loss * (NUFFT.type2 * Exp)).grad`` at 16^2 and 300 points: one
    interp and one spread through the rules, within the plan's eps of the
    JAX package's gradient (relative l2, float64, eps 1e-6)."""
    rng = np.random.default_rng(8)
    N, M = (16, 16), 300
    pts = rng.uniform(-math.pi, math.pi, (M, 2))
    y = rng.standard_normal((M, 2))
    x = 0.2 * rng.standard_normal(N)
    At = tnu.NUFFT.type2(pts, N, real=True, eps=1e-6, dtype=torch.float64,
                         device="cpu")
    assert At.kernel_path == "kernel"
    ft_ = tfunc.SquaredL2Norm((M, 2)).asloss(_t(y)) * (At * tfn.Exp(N))
    c = (nu.nufft_interp2.rule_calls["vjp"], nu.nufft_spread2.launches)
    got = ft_.grad(_t(x)).numpy()
    assert nu.nufft_interp2.rule_calls["vjp"] == c[0] + 1
    assert nu.nufft_spread2.launches == c[1]          # the CPU: none
    Aj = jnu.NUFFT.type2(pts, N, real=True, eps=1e-6)
    fj = jfunc.SquaredL2Norm((M, 2)).asloss(jnp.asarray(y)) * (
        Aj * jfn.Exp(N))
    want = np.asarray(jax.jit(fj.grad)(jnp.asarray(x)))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-6, rel
