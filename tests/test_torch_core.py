"""The port's operator core against pyxu_tpu's, on the CPU.

One numpy input goes through both packages (the JAX side under
``jax.jit``): the class the rule engine infers for compositions of
IdentityOp, HomothetyOp, a Stencil and a dense operator; ``squeeze``,
``expr``, ``**``, ``argscale`` and ``/``; ``jacobian`` of a DiffFunc and of
each rule; ``moreau_envelope``; ``pinv``, ``dagger``, ``asarray``,
``from_array`` and ``to_sciop``; UnitOp, ProjOp and OrthProjOp; DiagonalOp
and ExplicitLinOp; the four norms; ``shift_loss``, ``ConstantValued`` and
``from_source``.  Tolerance: ``atol_for`` times the output's largest
magnitude (at least 1).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import atol_for

import pyxu_tpu.abc as jabc
import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.abc as tabc
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.abc.operator import infer_operator_class as j_infer
from pyxu_tpu.operator.interop.source import from_source as j_source
from pyxu_tpu.operator.map.base import ConstantValued as JConst
from pyxu_tpu_torch.abc.operator import infer_operator_class as t_infer
from pyxu_tpu_torch.operator.interop.source import from_source as t_source
from pyxu_tpu_torch.operator.map.base import ConstantValued as TConst
from pyxu_tpu_torch.ops import stencil as st_kern

SHAPE = (4, 5)
K3 = np.array([0.25, 0.5, 0.25], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, fdtype, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_for(fdtype) * s)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _alternate(names):
    """(name, dtype) cases, f32 and f64 by turns: each check's JAX side is
    a compile, so each case runs at one width."""
    return [(n, np.dtype(np.float32 if i % 2 == 0 else np.float64))
            for i, n in enumerate(names)]


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _grouped_refs(cases, inputs, run_j, build=lambda case: case):
    """JAX references of a parametrised test: on first use at a width,
    every case of that width goes through one ``jax.jit`` (one compile, not
    one a case).  ``inputs(case, fdtype)`` gives a case's numpy arrays and
    ``run_j(build(case), *arrays)`` its JAX outputs: ``build`` runs outside
    the trace, for operators whose constructor reads its data on the host.
    Returns ``get(case, fdtype) -> (arrays, outputs)``."""
    cache = {}

    def get(case, fdtype):
        key = np.dtype(fdtype).name
        if key not in cache:
            mine = [c for c, d in cases if np.dtype(d) == np.dtype(fdtype)]
            arrs = {c: inputs(c, np.dtype(fdtype)) for c in mine}
            objs = {c: build(c) for c in mine}
            outs = jax.jit(lambda a: {c: run_j(objs[c], *a[c]) for c in mine})(
                {c: [jnp.asarray(v) for v in arrs[c]] for c in mine})
            cache[key] = (arrs, outs)
        arrs, outs = cache[key]
        return arrs[case], outs[case]
    return get


def _case_rng(case):
    return np.random.default_rng(zlib.crc32(case.encode()))


def _match(run_t, run_j, arrays, fdtype):
    """``run_t(*tensors)`` against ``jax.jit(run_j)(*arrays)``: the two
    return lists of outputs, compared one by one."""
    want = _jit(run_j, *(jnp.asarray(a) for a in arrays))
    got = run_t(*(_t(a) for a in arrays))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, fdtype)


# ------------------------------------------------------------ class matrix --

def _dense(pkg, rng_seed=3):
    m = np.random.default_rng(rng_seed).standard_normal(
        SHAPE + SHAPE).astype(np.float32)
    if pkg == "jax":
        return jlin.base.ExplicitLinOp(jnp.asarray(m), dim_rank=2)
    return tlin.ExplicitLinOp(_t(m), dim_rank=2)


@functools.cache
def _base_ops(pkg):
    """The four operators of the class matrix, built once a package (the
    tests read them and compose new operators around them)."""
    lin = jlin if pkg == "jax" else tlin
    return {"I": lin.IdentityOp(SHAPE), "H": lin.HomothetyOp(SHAPE, 2.0),
            "S": lin.Stencil(SHAPE, [K3, K3], [1, 1], mode="symmetric"),
            "A": _dense(pkg)}


_NAMES = ("I", "H", "S", "A")
MATRIX = ([(f"{c}*{a}", "scale", a, None, c) for a in _NAMES
           for c in (2.0, -1.0)]
          + [(f"{a}**{k}", "pow", a, None, k) for a in _NAMES
             for k in (0, 2, 3)]
          + [(f"{a}.T", "T", a, None, None) for a in _NAMES]
          + [(f"{a}+{b}", "add", a, b, None) for i, a in enumerate(_NAMES)
             for b in _NAMES[i:]]
          + [(f"{a}o{b}", "compose", a, b, None) for a in _NAMES
             for b in _NAMES])


def _combine(ops, kind, a, b, c):
    x = ops[a]
    if kind == "scale":
        return c * x
    if kind == "pow":
        return x ** c
    if kind == "T":
        return x.T
    if kind == "add":
        return x + ops[b]
    return x * ops[b]


@pytest.mark.parametrize("name,kind,a,b,c", MATRIX, ids=[m[0] for m in MATRIX])
def test_rule_engine_infers_the_jax_class(name, kind, a, b, c):
    """What the rule engine infers, class name by class name (2·I, I + I
    and I ∘ I were PosDefOp before IdentityOp became an OrthProjOp)."""
    j = _combine(_base_ops("jax"), kind, a, b, c)
    t = _combine(_base_ops("torch"), kind, a, b, c)
    assert t_infer(t.properties()).__name__ == j_infer(j.properties()).__name__
    assert sorted(p.name for p in t.properties()) == \
        sorted(p.name for p in j.properties())


def test_identity_properties_and_closed_forms():
    J, T = jlin.IdentityOp(SHAPE), tlin.IdentityOp(SHAPE)
    assert isinstance(T, tabc.OrthProjOp)
    assert sorted(p.name for p in T.properties()) == \
        sorted(p.name for p in J.properties())
    assert T.gram() is T and T.cogram() is T and T.trace() == J.trace()
    np.testing.assert_array_equal(T.svdvals(3, device="cpu").numpy(),
                                  np.asarray(J.svdvals(3)))
    np.testing.assert_array_equal(T.asarray(device="cpu").numpy(),
                                  np.asarray(J.asarray()))
    y = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    _close(T.pinv(_t(y), damp=0.5), J.pinv(jnp.asarray(y), damp=0.5),
           np.float32)
    assert len(tabc.core_operators()) == len(jabc.core_operators()) == 16
    assert [c.__name__ for c in tabc.core_operators()] == \
        [c.__name__ for c in jabc.core_operators()]


def test_identity_keeps_the_quadratic_and_cg_paths():
    """QuadraticFunc's default Q, a homothety's constant and G + lam I."""
    from pyxu_tpu.abc.arithmetic import _homothety_cst as jh
    from pyxu_tpu_torch.abc.arithmetic import _homothety_cst as th
    for pkg, abc, lin, h in (("jax", jabc, jlin, jh), ("torch", tabc, tlin,
                                                       th)):
        q = abc.QuadraticFunc(SHAPE)
        assert q.diff_lipschitz == 1.0 and h(q._Q) == 1.0
        G = _base_ops(pkg)["S"].gram()
        Q = G + 0.3 * lin.IdentityOp(SHAPE)
        assert type(Q).__name__ == "AddMixin[SelfAdjointOp]"
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    Jq = jabc.QuadraticFunc(SHAPE)
    Tq = tabc.QuadraticFunc(SHAPE)
    _close(Tq.prox(_t(x), 0.7), _jit(lambda v: Jq.prox(v, 0.7),
                                     jnp.asarray(x)), np.float32)


# ------------------------------------------- squeeze, expr, **, argscale, / --

def test_squeeze_matches_jax(fdtype, rng):
    m = rng.standard_normal((1, 6)).astype(fdtype)
    J = jlin.base.ExplicitLinOp(jnp.asarray(m)).squeeze()
    T = tlin.ExplicitLinOp(_t(m)).squeeze()
    assert T.codim_shape == J.codim_shape == ()
    assert t_infer(T.properties()).__name__ == "LinFunc"
    x = rng.standard_normal((3, 6)).astype(fdtype)
    _close(T.apply(_t(x)), J.apply(jnp.asarray(x)), fdtype)
    _close(T.grad(_t(x)), J.grad(jnp.asarray(x)), fdtype)
    _close(T.adjoint(_t(x[:, 0].copy())), J.adjoint(jnp.asarray(x[:, 0])),
           fdtype)
    D = t_source(tabc.DiffMap, (6,), (1,), apply=lambda v: v[..., :1] ** 2)
    assert D.squeeze().has(tabc.Property.DIFFERENTIABLE_FUNCTION)
    wide = tlin.ExplicitLinOp(_t(m.T.copy()))      # codim (6,): unchanged
    assert wide.squeeze() is wide


def _exprs(pkg):
    ops = _base_ops(pkg)
    func = jfunc if pkg == "jax" else tfunc
    S, A, H = ops["S"], ops["A"], ops["H"]
    f = func.SquaredL2Norm(SHAPE)
    return [(2 * S).argscale(3.0), S.T * A + H, H ** 3, S / 4.0,
            f * S, func.L1Norm(SHAPE).moreau_envelope(0.5), S.gram(),
            A.cogram(), S.dagger(0.1), (f * A).jacobian(np.ones(SHAPE,
                                                                np.float32))]


def test_expr_matches_jax():
    for j, t in zip(_exprs("jax"), _exprs("torch")):
        assert t.expr() == j.expr()


POW_BUILD = {
    "pow": lambda o, f: o["S"] ** 3,
    "div": lambda o, f: o["A"] / 4.0,
    "argscale_lin": lambda o, f: o["S"].argscale(-1.5),
    "argscale_func": lambda o, f: f.L1Norm(SHAPE).argscale(2.0),
    "argscale_quad": lambda o, f: (
        0.5 * f.SquaredL2Norm(SHAPE) * o["S"]).argscale(0.5),
}
POW_CASES = [(w, np.dtype(d)) for w, d in (
    ("pow", np.float32), ("div", np.float64), ("argscale_lin", np.float32),
    ("argscale_func", np.float64), ("argscale_quad", np.float64))]


def _pow_methods(op):
    P = tabc.Property
    methods = [("apply", lambda o, v: o.apply(v))]
    if op.has(P.LINEAR):
        methods += [("adjoint", lambda o, v: o.adjoint(v)),
                    ("asarray", lambda o, v: o.asarray(dtype=v.dtype))]
    if op.has(P.PROXIMABLE):
        methods += [("prox", lambda o, v: o.prox(v, 0.3))]
    if op.has(P.DIFFERENTIABLE_FUNCTION):
        methods += [("grad", lambda o, v: o.grad(v))]
    return methods


def _pow_run(J, x):
    return [m(J, x) for _, m in _pow_methods(J)]


_pow_refs = _grouped_refs(
    POW_CASES, lambda c, dt: [_case_rng(c).standard_normal(
        (2,) + SHAPE).astype(dt)], _pow_run,
    build=lambda w: POW_BUILD[w](_base_ops("jax"), jfunc))


@pytest.mark.parametrize("which,fdtype", POW_CASES)
def test_pow_div_argscale_match_jax(which, fdtype):
    J = POW_BUILD[which](_base_ops("jax"), jfunc)
    T = POW_BUILD[which](_base_ops("torch"), tfunc)
    assert t_infer(T.properties()).__name__ == \
        j_infer(J.properties()).__name__
    (x,), want = _pow_refs(which, fdtype)
    dt = _t(x).dtype
    for (name, m), w in zip(_pow_methods(T), want):
        got = T.asarray(dtype=dt, device="cpu") if name == "asarray" \
            else m(T, _t(x))
        _close(got, w, fdtype)
    assert T.lipschitz == pytest.approx(J.lipschitz)
    assert T._diff_lipschitz == pytest.approx(J._diff_lipschitz)


def test_argscale_and_power_rules():
    S = _base_ops("torch")["S"]
    assert S.argscale(1.0) is S
    with pytest.raises(ValueError):
        S.argscale(0.0)
    nested = S.argscale(2.0).argscale(3.0)
    assert nested._cst == 6.0 and nested._op is S
    assert isinstance(S ** 0, tlin.IdentityOp) and (S ** 1) is S
    P = tlin.HomothetyOp(SHAPE, 2.0) ** 2
    assert P.has(tabc.Property.LINEAR_POSITIVE_DEFINITE)


# ---------------------------------------------------------------- jacobian --

def _diffmaps(pkg):
    """A non-linear DiffMap D (tanh), a second one E (sin), a dense LinOp
    A, a codim-1 map C, and SquaredL2Norm f, all over (3, 4)."""
    src, abc, func = (j_source, jabc, jfunc) if pkg == "jax" else (
        t_source, tabc, tfunc)
    xp = jnp if pkg == "jax" else torch
    D = src(abc.DiffMap, (3, 4), (3, 4), apply=lambda v: xp.tanh(v))
    E = src(abc.DiffMap, (3, 4), (3, 4), apply=lambda v: xp.sin(v) * 0.5)
    C = src(abc.DiffMap, (3, 4), (1,),
            apply=lambda v: xp.sum(v ** 3, axis=(-2, -1))[..., None]
            if pkg == "jax" else torch.sum(v ** 3, dim=(-2, -1))[..., None])
    m = np.random.default_rng(5).standard_normal((3, 4, 3, 4)).astype(
        np.float32) / 4
    A = (jlin.base.ExplicitLinOp(jnp.asarray(m), dim_rank=2) if pkg == "jax"
         else tlin.ExplicitLinOp(_t(m), dim_rank=2))
    f = func.SquaredL2Norm((3, 4))
    return D, E, A, C, f


JAC_RULES = {
    "difffunc": lambda D, E, A, C, f, s: f.asloss(s),
    "scale": lambda D, E, A, C, f, s: -2.0 * D,
    "argscale": lambda D, E, A, C, f, s: D.argscale(0.5),
    "argshift": lambda D, E, A, C, f, s: D.argshift(s),
    "add": lambda D, E, A, C, f, s: D + E,
    "chain": lambda D, E, A, C, f, s: D * A,
    "chain_linear_lhs": lambda D, E, A, C, f, s: A * D,
    "chain_func": lambda D, E, A, C, f, s: f * D,
    "cast": lambda D, E, A, C, f, s: C.squeeze(),
}


JAC_CASES = _alternate(sorted(JAC_RULES))


def _jac_inputs(rule, dt):
    rng = _case_rng(rule)
    T = JAC_RULES[rule](*_diffmaps("torch"), torch.zeros(3, 4))
    return [rng.standard_normal(shape).astype(dt) for shape in (
        (3, 4), (3, 4), (2, 3, 4), (2,) + T.codim_shape)]


def _jac_run(rule, s, x, v, w):
    J = JAC_RULES[rule](*_diffmaps("jax"), s)
    return [J.jacobian(x).apply(v), J.jacobian(x).adjoint(w)]


_jac_refs = _grouped_refs(JAC_CASES, _jac_inputs, _jac_run)


@pytest.mark.parametrize("rule,fdtype", JAC_CASES)
def test_jacobian_matches_jax(rule, fdtype):
    (s, x, v, w), want = _jac_refs(rule, fdtype)
    T = JAC_RULES[rule](*_diffmaps("torch"), _t(s))
    JT = T.jacobian(_t(x))
    assert JT.dim_shape == T.dim_shape and JT.codim_shape == T.codim_shape
    _close(JT.apply(_t(v)), want[0], fdtype)
    _close(JT.adjoint(_t(w)), want[1], fdtype)
    _close(JT.apply(_t(v[0])), want[0][0], fdtype)    # unbatched as well


def test_jacobian_of_constant_map_and_linear_op():
    Cm = TConst((3,), (2,), 1.5)
    assert isinstance(Cm.jacobian(torch.zeros(3)), tlin.NullOp)
    A = _diffmaps("torch")[2]
    At = A.T
    assert A.jacobian(torch.zeros(3, 4)) is A and At.jacobian(0) is At


def test_jacobian_never_differentiates_a_kernel_on_the_card(monkeypatch):
    """A Chain composes its parts' Jacobians, so a Stencil on the kernel
    path is applied as itself; a transform that reaches the kernel wrapper
    runs through its autograd rule (counted; on a CPU tensor the rule's
    launches are the plain version's, so no kernel launch is counted) and
    gives the numbers of autograd through the plain version."""
    S = tlin.Stencil((16, 16), [K3, K3], [1, 1], mode="symmetric")
    assert S.kernel_path == "kernel"
    D = t_source(tabc.DiffMap, (16, 16), (16, 16), apply=torch.tanh)
    n0 = st_kern.separable_correlate2d.launches
    J = (D * S).jacobian(torch.zeros((16, 16)))
    assert J._expr()[0] == "compose" and J._rhs is S
    rng = np.random.default_rng(0)
    x, v = (_t(rng.standard_normal((16, 16))) for _ in range(2))
    f = tfunc.SquaredL2Norm((16, 16)) * S
    calls = st_kern.separable_correlate2d.rule_calls

    def run():
        xg = x.clone().requires_grad_(True)
        S.apply(xg).pow(2).sum().backward()
        return [torch.func.jvp(S.apply, (x,), (v,))[1],
                f.jacobian(x).apply(v), xg.grad]
    c0 = dict(calls)
    got = run()
    assert calls["jvp"] > c0.get("jvp", 0) and calls["vjp"] > c0.get(
        "vjp", 0)
    with monkeypatch.context() as m:     # the plain version's own graph
        m.setattr(st_kern, "under_autodiff", lambda *t: False)
        want = run()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    assert st_kern.separable_correlate2d.launches == n0


# ------------------------------------------------------- moreau envelopes --

ENVELOPES = {
    "l1": lambda f, s: f.L1Norm(s),
    "l21": lambda f, s: f.L21Norm(s, l2_axis=0),
    "positive_l1": lambda f, s: f.PositiveL1Norm(s),
    "squared_l1": lambda f, s: f.SquaredL1Norm(s),
    "l2_ball": lambda f, s: f.L2Ball(s, radius=0.8),
}


ENV_CASES = _alternate(sorted(ENVELOPES))


def _env_run(which, x):
    J = ENVELOPES[which](jfunc, SHAPE).moreau_envelope(0.3)
    return [J.apply(x), J.grad(x)]


_env_refs = _grouped_refs(
    ENV_CASES, lambda c, dt: [_case_rng(c).standard_normal(
        (2,) + SHAPE).astype(dt)], _env_run)


@pytest.mark.parametrize("which,fdtype", ENV_CASES)
def test_moreau_envelope_matches_jax(which, fdtype):
    J = ENVELOPES[which](jfunc, SHAPE).moreau_envelope(0.3)
    T = ENVELOPES[which](tfunc, SHAPE).moreau_envelope(0.3)
    assert T.diff_lipschitz == J.diff_lipschitz == pytest.approx(1 / 0.3)
    assert t_infer(T.properties()).__name__ == "DiffFunc"
    (x,), want = _env_refs(which, fdtype)
    _close(T.apply(_t(x)), want[0], fdtype)
    _close(T.grad(_t(x)), want[1], fdtype)


# ---------------------------------- pinv, dagger, asarray, from_array, sciop --

@pytest.mark.parametrize("which,fdtype", [
    ("S", np.dtype(np.float32)), ("A", np.dtype(np.float64))])
def test_pinv_dagger_asarray_match_jax(which, fdtype, rng):
    """CG stops at rtol: tighter than the f64 tolerance only when asked."""
    J, T = _base_ops("jax")[which], _base_ops("torch")[which]
    kw = {"rtol": 1e-12} if fdtype == np.float64 else {}
    y = rng.standard_normal(SHAPE).astype(fdtype)
    yb = rng.standard_normal((2,) + SHAPE).astype(fdtype)
    got = T.pinv(_t(y), damp=0.1, **kw)
    Dj, Dt = J.dagger(0.1), T.dagger(0.1)
    x0 = got + 0.01
    want = _jit(lambda a, b, c: (
        J.pinv(a, damp=0.1, **kw), Dj.apply(b), Dj.adjoint(b),
        J.asarray(dtype=a.dtype),
        J.pinv(a, damp=0.1, kwargs_init={"x0": c}, rtol=1e-3)),
        jnp.asarray(y), jnp.asarray(yb), jnp.asarray(x0.numpy()))
    _close(got, want[0], fdtype)
    assert torch.equal(T.dagger(0.1).apply(_t(y)),
                       T.pinv(_t(y), damp=0.1))
    assert Dt.dim_shape == Dj.dim_shape and Dt.codim_shape == Dj.codim_shape
    tol = 1.0 if fdtype == np.float32 else 1e3      # the daggers' own rtol
    _close(Dt.apply(_t(yb)), want[1], fdtype,
           scale=tol * max(1.0, float(np.abs(want[1]).max())))
    _close(Dt.adjoint(_t(yb)), want[2], fdtype,
           scale=tol * max(1.0, float(np.abs(want[2]).max())))
    _close(T.asarray(dtype=_t(y).dtype, device="cpu"), want[3], fdtype)
    _close(T.pinv(_t(y), damp=0.1, kwargs_init={"x0": x0}, rtol=1e-3),
           want[4], fdtype, scale=1e3 if fdtype == np.float64 else None)
    with pytest.raises(AssertionError, match="unknown pinv kwargs"):
        T.pinv(_t(y), tol=1e-3)


def test_from_array_and_to_sciop_match_jax(fdtype, rng):
    m = rng.standard_normal((3, 4, 5)).astype(fdtype)
    J = jabc.LinOp.from_array(jnp.asarray(m), dim_rank=1)
    T = tabc.LinOp.from_array(m, dim_rank=1, device="cpu")
    assert isinstance(T, tlin.ExplicitLinOp) and T._mat.device.type == "cpu"
    assert T.dim_shape == J.dim_shape and T.codim_shape == J.codim_shape
    x = rng.standard_normal((2, 5)).astype(fdtype)
    _close(T.apply(_t(x)), J.apply(jnp.asarray(x)), fdtype)
    Sj, St = J.to_sciop(dtype=fdtype), T.to_sciop(
        dtype=torch.float64 if fdtype == np.float64 else torch.float32,
        device="cpu")
    assert St.shape == Sj.shape == (12, 5) and St.dtype == Sj.dtype
    v, u, V = x[0], rng.standard_normal(12), rng.standard_normal((5, 3))
    _close(St.matvec(v), Sj.matvec(v), fdtype)
    _close(St.rmatvec(u), Sj.rmatvec(u), fdtype)
    _close(St.matmat(V), Sj.matmat(V), fdtype)
    # a Stencil's, against its dense matrix (its applies are held against
    # the JAX package's elsewhere)
    K = _base_ops("torch")["S"]
    dt = torch.float64 if fdtype == np.float64 else torch.float32
    St = K.to_sciop(dtype=dt, device="cpu")
    M = K.asarray(dtype=torch.float64, device="cpu").reshape(20, 20).numpy()
    u = rng.standard_normal(K.dim_size)
    _close(St.matvec(u), M @ u, fdtype)
    _close(St.rmatvec(u), M.T @ u, fdtype)
    # sparse input dispatches to SparseExplicitLinOp, as in the JAX package
    for A in (sp.eye(4, format="csr"), torch.eye(4).to_sparse()):
        S = tabc.LinOp.from_array(A, device="cpu")
        assert isinstance(S, tlin.SparseExplicitLinOp)
        assert type(S).__name__ == type(
            jabc.LinOp.from_array(sp.eye(4, format="csr"))).__name__
        u = _t(rng.standard_normal(4).astype(np.float32))
        _close(S.apply(u), u.numpy(), np.float32)


def test_explicit_and_diagonal_closed_forms(fdtype, rng):
    m = rng.standard_normal((4, 4)).astype(fdtype)
    v = rng.uniform(0.5, 2.0, 6).astype(fdtype)
    for J, T in ((jlin.base.ExplicitLinOp(jnp.asarray(m)),
                  tlin.ExplicitLinOp(_t(m))),
                 (jlin.base.DiagonalOp(jnp.asarray(v)),
                  tlin.DiagonalOp(_t(v))),
                 (jlin.base.DiagonalOp(jnp.asarray(v - 1.0)),
                  tlin.DiagonalOp(_t(v - 1.0)))):
        assert t_infer(T.properties()).__name__ == \
            j_infer(J.properties()).__name__
        y = rng.standard_normal((2,) + T.codim_shape).astype(fdtype)

        def run(op, a):
            return [op.svdvals(k=2), op.asarray(), op.pinv(a, damp=0.2),
                    op.adjoint(a)]
        _match(lambda a: run(T, a), lambda a: run(J, a), [y], fdtype)
        # host floats from the exact forms: M's trace, ||M||_2 by an SVD
        M = np.asarray(J.asarray(), np.float64).reshape(T.codim_size, -1)
        assert T.trace() == pytest.approx(np.trace(M), rel=1e-5)
        assert T.estimate_lipschitz() == pytest.approx(
            np.linalg.norm(M, 2), rel=1e-5)
    with pytest.raises(TypeError):
        tlin.ExplicitLinOp(sp.eye(3, format="csr"))


def test_closed_forms_of_the_elementary_ops():
    H, N = tlin.HomothetyOp(SHAPE, -1.5), tlin.NullOp(SHAPE, (3,))
    Hj, Nj = jlin.HomothetyOp(SHAPE, -1.5), jlin.NullOp(SHAPE, (3,))
    assert H.trace() == Hj.trace() and H.estimate_lipschitz() == 1.5
    np.testing.assert_array_equal(H.svdvals(2, device="cpu").numpy(),
                                  np.asarray(Hj.svdvals(2)))
    np.testing.assert_array_equal(H.asarray(device="cpu").numpy(),
                                  np.asarray(Hj.asarray()))
    np.testing.assert_array_equal(N.asarray(device="cpu").numpy(),
                                  np.asarray(Nj.asarray()))
    y = np.linspace(-1, 1, 20, dtype=np.float32).reshape(SHAPE)
    _close(H.pinv(_t(y), damp=0.5), Hj.pinv(jnp.asarray(y), damp=0.5),
           np.float32)
    assert N.estimate_lipschitz() == 0.0 and float(N.svdvals(device="cpu")) \
        == 0.0


# ----------------------------------------------- UnitOp, ProjOp, OrthProjOp --

def _structured(pkg, kind, fdtype):
    rng = np.random.default_rng(11)
    n = 6
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if kind == "unit":
        M = Q
    elif kind == "orth":
        M = Q[:, :3] @ Q[:, :3].T
    else:                      # an oblique projection onto range(B)
        B, C = rng.standard_normal((n, 2)), rng.standard_normal((n, 2))
        M = B @ np.linalg.solve(C.T @ B, C.T)
    M = M.astype(fdtype)
    cls = {"unit": "UnitOp", "orth": "OrthProjOp", "proj": "ProjOp"}[kind]
    if pkg == "jax":
        Mj = jnp.asarray(M)
        return j_source(getattr(jabc, cls), (n,), (n,),
                        apply=lambda v: v @ Mj.T, adjoint=lambda v: v @ Mj)
    Mt = _t(M)
    return t_source(getattr(tabc, cls), (n,), (n,),
                    apply=lambda v: v @ Mt.T, adjoint=lambda v: v @ Mt)


@pytest.mark.parametrize("kind,fdtype", _alternate(
    ["unit", "proj", "orth", "proj"]))
def test_unit_proj_orthproj_match_jax(kind, fdtype, rng):
    J, T = _structured("jax", kind, fdtype), _structured("torch", kind,
                                                         fdtype)
    assert sorted(p.name for p in T.properties()) == \
        sorted(p.name for p in J.properties())
    y = rng.standard_normal((2, 6)).astype(fdtype)
    Fj, Ft = jfunc.L1Norm((6,)) * J, tfunc.L1Norm((6,)) * T

    def run(op, F, v):
        D = op.dagger(0.25)
        out = [op.pinv(v, damp=0.0), op.pinv(v, damp=0.25), D.apply(v),
               D.adjoint(v), op.gram().apply(v), op.cogram().apply(v)]
        return out + ([F.prox(v, 0.3)] if kind == "unit" else [])

    for got, want in zip(run(T, Ft, _t(y)),
                         _jit(lambda v: run(J, Fj, v), jnp.asarray(y))):
        _close(got, want, fdtype)
    if kind == "orth":
        assert T.gram() is T and T.cogram() is T
    if kind == "unit":
        np.testing.assert_array_equal(T.svdvals(3, device="cpu").numpy(),
                                      np.asarray(J.svdvals(3)))
        # prox survives composition with a unitary operator
        assert Ft.has(tabc.Property.PROXIMABLE)
    assert T.lipschitz == J.lipschitz
    assert T.estimate_lipschitz(device="cpu", dtype=_t(y).dtype) == pytest.approx(
        J.estimate_lipschitz(), rel=1e-4)


def test_linfunc_svdvals_asarray_match_jax(fdtype, rng):
    w = rng.standard_normal(SHAPE).astype(fdtype)
    J = jlin.ExplicitLinFunc(jnp.asarray(w))
    T = tlin.ExplicitLinFunc(_t(w))
    dt = torch.float64 if fdtype == np.float64 else torch.float32
    # both estimate ||w|| at the policy's width (f32)
    _close(T.svdvals(k=3, device="cpu"), J.svdvals(k=3), np.float32)
    _close(T.asarray(dtype=dt, device="cpu"), J.asarray(dtype=fdtype),
           fdtype)


# ----------------------------------------------------------------- norms --

NORMS = {
    "l2": lambda f: f.L2Norm(SHAPE),
    "squared_l1_sort": lambda f: f.SquaredL1Norm(SHAPE),
    "squared_l1_root": lambda f: f.SquaredL1Norm(SHAPE, prox_algo="root"),
    "linf": lambda f: f.LInfinityNorm(SHAPE),
    "positive_l1": lambda f: f.PositiveL1Norm(SHAPE),
}


NORM_CASES = _alternate(
    ["l2", "linf", "positive_l1", "squared_l1_sort", "squared_l1_sort",
     "squared_l1_root", "squared_l1_root"])


def _norm_inputs(which, dt):
    rng = _case_rng(which)
    x = rng.standard_normal((3,) + SHAPE).astype(dt)
    x[1] = np.abs(x[1])                  # one sample inside the orthant
    x[2] *= 1e-3                         # one small in magnitude
    return [x, np.array([0.1, 0.5, 2.0], dt)]


def _norm_run(which, x, tau_b, pkg=jfunc):
    op = NORMS[which](pkg)
    out = [op.apply(x), op.prox(x, 0.05), op.prox(x, 0.7)]
    if which.startswith("squared_l1"):      # a tau per batch element
        out.append(op.prox(x, tau_b))
    return out


_norm_refs = _grouped_refs(NORM_CASES, _norm_inputs, _norm_run)


@pytest.mark.parametrize("which,fdtype", NORM_CASES)
def test_norms_match_jax(which, fdtype):
    (x, tau_b), want = _norm_refs(which, fdtype)
    got = _norm_run(which, _t(x), _t(tau_b), pkg=tfunc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, fdtype)
    T = NORMS[which](tfunc)
    assert T.lipschitz == NORMS[which](jfunc).lipschitz
    if which == "linf":
        _close(T.prox(_t(x), 0.0), x, fdtype)


# --------------------------------- shift_loss, ConstantValued, from_source --

def test_shift_loss_and_constant_valued(fdtype, rng):
    from pyxu_tpu.operator.func.loss import shift_loss as js
    from pyxu_tpu_torch.operator.func.loss import shift_loss as ts
    d = rng.standard_normal(SHAPE).astype(fdtype)
    x = rng.standard_normal((2,) + SHAPE).astype(fdtype)
    T = ts(tfunc.L1Norm(SHAPE), _t(d))
    assert ts(T, None) is T
    Tq = ts(tfunc.SquaredL2Norm(SHAPE), _t(d))
    Jq = js(jfunc.SquaredL2Norm(SHAPE), jnp.asarray(d))
    assert type(Tq).__name__ == type(Jq).__name__ == "QuadraticFunc"
    shapes = ((), (1,), (3,))
    for shape in shapes:
        Jc, Tc = JConst(SHAPE, shape, 2.5), TConst(SHAPE, shape, 2.5)
        assert type(Tc).__name__ == type(Jc).__name__
        assert Tc.codim_shape == Jc.codim_shape
        assert Tc.apply(_t(x)).dtype == _t(x).dtype
        if shape != (3,):
            assert Tc.diff_lipschitz == Tc.lipschitz == 0.0

    def run(func, const, shift, v, dd):
        f, q = shift(func.L1Norm(SHAPE), dd), shift(func.SquaredL2Norm(
            SHAPE), dd)
        out = [f.apply(v), f.prox(v, 0.4), q.apply(v), q.grad(v)]
        for shape in shapes:
            c = const(SHAPE, shape, 2.5)
            out.append(c.apply(v))
            if shape != (3,):
                out += [c.grad(v), c.prox(v, 0.3)]
        return out
    _match(lambda *a: run(tfunc, TConst, ts, *a),
           lambda *a: run(jfunc, JConst, js, *a), [x, d], fdtype)


def test_from_source_matches_jax(fdtype, rng):
    w = rng.standard_normal((3, 4)).astype(fdtype)

    def build(src, abc, lin, xp, sum_):
        wx = xp.asarray(w) if xp is jnp else _t(w)
        Q = lin.HomothetyOp((4,), 3.0)
        return (
            src(abc.LinOp, (4,), (3,), embed={"tag": 7}, lipschitz=2.0,
                apply=lambda v: v @ wx.T),
            # single-sample callables, vectorised over the batch
            src(abc.DiffFunc, (4,), vectorize=("apply", "grad"),
                apply=lambda v: sum_(v ** 2) * 0.5, grad=lambda v: v),
            # the quadratic spec feeds grad and prox
            src(abc.QuadraticFunc, (4,),
                apply=lambda v: 1.5 * sum_(v * v, -1),
                _quad_spec=lambda: (Q, lin.NullFunc((4,)), 0.0)))

    J = build(j_source, jabc, jlin, jnp, jnp.sum)
    T = build(t_source, tabc, tlin, torch, torch.sum)
    assert [type(o).__name__ for o in T] == [type(o).__name__ for o in J]
    assert T[0].tag == 7 and T[0].lipschitz == 2.0
    assert [o.expr() for o in T] == [o.expr() for o in J]

    def run(ops, x, y, xb):
        lin, vec, quad = ops
        return [lin.apply(x), lin.adjoint(y),        # the adjoint by autodiff
                vec.apply(xb), vec.grad(xb), quad.grad(x), quad.prox(x, 0.5)]
    arrays = [rng.standard_normal(s).astype(fdtype)
              for s in ((2, 4), (2, 3), (2, 3, 4))]
    _match(lambda *a: run(T, *a), lambda *a: run(J, *a), arrays, fdtype)
    # enforce_precision casts to the policy's width
    Te = t_source(tabc.Map, (4,), (4,), apply=lambda v: v * 2,
                  enforce_precision="apply")
    assert Te.apply(torch.ones(4, dtype=torch.float64)).dtype == torch.float32
    with pytest.raises(AssertionError):
        t_source(tabc.Map, (4,), (4,), bogus=1)
    with pytest.raises(NotImplementedError):
        t_source(tabc.ProxFunc, (4,), apply=torch.sum).prox(torch.ones(4),
                                                            1.0)


# ------------------------------------------- flat API, runtime, utilities --

def _flat_ops():
    """(JAX, port) pairs: a Gradient, a functional, a Stencil, a dense op."""
    k = np.asarray([0.25, 0.5, 0.25], np.float32)
    A = np.random.default_rng(9).standard_normal((6, 4, 5)).astype(
        np.float32)
    return {
        "gradient": (jlin.Gradient((4, 5)), tlin.Gradient((4, 5))),
        "l1": (jfunc.L1Norm((6,)), tfunc.L1Norm((6,))),
        "stencil": (jlin.Stencil((4, 5), [jnp.asarray(k)] * 2, [1, 1]),
                    tlin.Stencil((4, 5), [k, k], [1, 1])),
        "dense": (jabc.LinOp.from_array(jnp.asarray(A), dim_rank=2),
                  tabc.LinOp.from_array(A, dim_rank=2, device="cpu")),
    }


@pytest.mark.parametrize("name", ["gradient", "l1", "stencil", "dense"])
def test_flat_api_matches_jax(name):
    """``dim``, ``codim``, ``shape`` and ``ravel``/``unravel`` of a batched
    output, against the JAX package (``tests/test_compat_shims.py``'s
    ``TestFlatAPICompat``)."""
    jop, top = _flat_ops()[name]
    assert (top.dim, top.codim, top.shape) == (jop.dim, jop.codim, jop.shape)
    x = np.random.default_rng(1).standard_normal((3,) + jop.dim_shape) \
        .astype(np.float32)
    jy = jax.jit(jop.apply)(x)
    ty = top.apply(torch.from_numpy(x))
    jflat, tflat = jop.ravel(jy), top.ravel(ty)
    assert tuple(tflat.shape) == tuple(jflat.shape) == (3, jop.codim)
    np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), rtol=0,
                               atol=atol_for(np.float32) * max(
                                   1.0, float(abs(jy).max())))
    back = top.unravel(tflat)
    assert tuple(back.shape) == tuple(jop.unravel(jflat).shape)
    assert torch.equal(back, ty)
    # a numpy input, and an unbatched one
    assert tuple(top.ravel(ty[0].numpy()).shape) == (top.codim,)


def test_flat_api_shapes_of_compat_shims():
    """The JAX package's own cases: Gradient((4, 5)) and L1Norm((6,))."""
    g = tlin.Gradient((4, 5))
    assert g.dim == 20 and g.codim == 40 and g.shape == (40, 20)
    y = g.apply(torch.ones((3, 4, 5)))
    assert tuple(g.ravel(y).shape) == (3, 40)
    assert tuple(g.unravel(g.ravel(y)).shape) == (3, 2, 4, 5)
    f = tfunc.L1Norm((6,))
    assert f.shape == (1, 6) and f.dim == 6 and f.codim == 1


def test_arithmetic_methods_match_jax():
    """``Property.arithmetic_methods`` gives the JAX package's set for
    every property."""
    from pyxu_tpu.abc.operator import Property as JP
    from pyxu_tpu_torch.abc.operator import Property as TP
    assert [p.name for p in TP] == [p.name for p in JP]
    for p in TP:
        assert p.arithmetic_methods() == JP[p.name].arithmetic_methods(), p
    assert "prox" in TP.PROXIMABLE.arithmetic_methods()
    assert TP.FUNCTIONAL.arithmetic_methods() == frozenset()


def test_runtime_names_match_jax():
    """``pyxu_tpu_torch.runtime`` exports the JAX package's precision names
    (``enable_x64`` aside) from ``info/dtypes.py``."""
    import pyxu_tpu.runtime as jrt
    import pyxu_tpu_torch.info.dtypes as tdt
    import pyxu_tpu_torch.runtime as trt
    names = ("CWidth", "EnforcePrecision", "enforce_precision", "coerce",
             "default_cdtype", "getCoerceState")
    for name in names:
        assert name in trt.__all__ and name in jrt.__all__, name
        assert getattr(trt, name) is getattr(tdt, name), name
    assert set(jrt.__all__) - set(trt.__all__) == {"enable_x64"}
    assert trt.default_cdtype() == torch.complex64
    with trt.EnforcePrecision(False):
        assert trt.getCoerceState() is False
    assert trt.getCoerceState() is True
    assert trt.coerce(torch.ones(2, dtype=torch.float64)).dtype == \
        torch.float32
    assert trt.CWidth.SINGLE.real is trt.Width.SINGLE


def test_next_fast_len_even_matches_jax():
    from pyxu_tpu.utils.misc import next_fast_len as jnfl
    from pyxu_tpu_torch.utils.misc import next_fast_len as tnfl
    for n in range(1, 301):
        assert tnfl(n, even=True) == jnfl(n, even=True), n
        assert tnfl(n) == jnfl(n), n
        assert tnfl(n, even=True) % 2 == 0


def test_version_matches_jax():
    import pyxu_tpu
    import pyxu_tpu_torch
    assert pyxu_tpu_torch.__version__ == pyxu_tpu.__version__
