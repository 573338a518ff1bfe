"""The rest of the port's operator library against pyxu_tpu's, on the CPU.

SubSample, Trim and Sum; SparseExplicitLinOp (scipy and torch sparse
input, ``asarray``, ``trace``, ``from_array``); ``kron`` and
``khatri_rao``; the element-wise maps with their Jacobians and declared
constants, SoftMax and the functional forms; the edge filters' gradient
magnitude and StructureTensor (apply and Jacobian); ``from_sciop``,
``from_torch``, ``asarray`` and ``astensor``; and the utilities of
``utils/misc.py``, ``utils/complex.py`` and ``info/dtypes.py``.  One numpy
input goes through both packages (the JAX side under one ``jax.jit`` a
width).  Tolerance: ``atol_for`` times the output's largest magnitude (at
least 1).
"""

import math
import types
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch
from conftest import atol_for

import pyxu_tpu.abc as jabc
import pyxu_tpu.info.dtypes as jdt
import pyxu_tpu.operator as jop
import pyxu_tpu.operator.interop as jint
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu.operator.map.ufunc as jfn
import pyxu_tpu.utils as jutil
import pyxu_tpu_torch.abc as tabc
import pyxu_tpu_torch.info as tinfo
import pyxu_tpu_torch.operator as top
import pyxu_tpu_torch.operator.interop as tint
import pyxu_tpu_torch.operator.linop as tlin
import pyxu_tpu_torch.operator.map.ufunc as tfn
import pyxu_tpu_torch.utils as tutil
from pyxu_tpu_torch.info import warnings as twarn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = (6, 5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, fdtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_for(fdtype) * s)


def _pkg(name, fdtype):
    if name == "jax":
        return types.SimpleNamespace(L=jlin, O=jop, dev={},
                                     a=lambda v: jnp.asarray(v, fdtype))
    return types.SimpleNamespace(L=tlin, O=top, dev={"device": "cpu"},
                                 a=lambda v: _t(np.asarray(v, fdtype)))


def _csr(shape, seed, density=0.3):
    return sp.random(*shape, density=density, format="csr",
                     random_state=seed)


def _mat(P, shape, seed):
    return P.L.ExplicitLinOp(P.a(np.random.default_rng(seed)
                                 .standard_normal(shape)))


# --------------------------------------------------------- linear operators

LINOPS = {
    "subsample": lambda P: P.L.SubSample(S, slice(1, None, 2), [0, 3, 3, -1]),
    "subsample_mask": lambda P: P.L.SubSample(
        S, np.array([True, False, True, True, False, False]), 2),
    "trim": lambda P: P.L.Trim(S, ((1, 2), (0, 1))),
    "sum": lambda P: P.L.Sum((3, 4, 5)),
    "sum_axes": lambda P: P.L.Sum((3, 4, 5), axis=(0, -1)),
    "sparse": lambda P: P.L.SparseExplicitLinOp(_csr((7, 9), 1), **P.dev),
    "sparse_shaped": lambda P: P.L.SparseExplicitLinOp(
        _csr((30, 30), 2), dim_shape=S, codim_shape=S, **P.dev),
    "kron": lambda P: P.L.kron(_mat(P, (3, 4), 3), _mat(P, (2, 5), 4)),
    "kron_stencil": lambda P: P.L.kron(
        P.L.Stencil((5,), P.a([0.2, 0.5, 0.3]), 1, mode="symmetric"),
        _mat(P, (3, 4), 5)),
    "khatri_rao": lambda P: P.L.khatri_rao(_mat(P, (3, 4), 6),
                                           _mat(P, (2, 4), 7)),
}
WIDTH_OF = {n: (np.float32, np.float64)[i % 2]
            for i, n in enumerate(sorted(LINOPS))}
_REFS = {}


def _basis_apply(op, fdtype):
    n = op.dim_size
    cols = op.apply(jnp.eye(n, dtype=fdtype).reshape((n,) + op.dim_shape))
    return cols.reshape(n, -1).T.reshape(op.codim_shape + op.dim_shape)


def _refs(fdtype):
    key = np.dtype(fdtype).name
    if key not in _REFS:
        P = _pkg("jax", fdtype)
        with jdt.Precision(jdt.Width(np.dtype(fdtype))):
            ops = {n: b(P) for n, b in LINOPS.items()
                   if WIDTH_OF[n] == fdtype}
        arrs = {}
        for n, op in ops.items():
            rng = np.random.default_rng(zlib.crc32(n.encode()))
            arrs[n] = (rng.standard_normal((2,) + op.dim_shape).astype(fdtype),
                       rng.standard_normal((2,) + op.codim_shape)
                       .astype(fdtype))
        outs = jax.jit(lambda a: {
            n: [op.apply(a[n][0]), op.adjoint(a[n][1]),
                _basis_apply(op, fdtype)] for n, op in ops.items()})(
            {n: [jnp.asarray(v) for v in arrs[n]] for n in ops})
        _REFS[key] = (ops, arrs, outs)
    return _REFS[key]


@pytest.mark.parametrize("name", sorted(LINOPS))
def test_linop_matches_jax(name):
    fdtype = WIDTH_OF[name]
    jops, arrs, outs = _refs(fdtype)
    J = jops[name]
    width = tinfo.Width.DOUBLE if fdtype == np.float64 else \
        tinfo.Width.SINGLE
    with tinfo.Precision(width):
        T = LINOPS[name](_pkg("torch", fdtype))
    assert (T.dim_shape, T.codim_shape) == (J.dim_shape, J.codim_shape)
    x, y = arrs[name]
    _close(T.apply(_t(x)), outs[name][0], fdtype)
    _close(T.adjoint(_t(y)), outs[name][1], fdtype)
    _close(T.asarray(dtype=width.value, device="cpu"), outs[name][2],
           fdtype)
    if math.isfinite(J.lipschitz):
        assert T.lipschitz == pytest.approx(J.lipschitz, rel=1e-6)
    else:
        assert not math.isfinite(T.lipschitz)


def test_sparse_layouts_trace_and_from_array():
    A = _csr((8, 8), 3, density=0.5) + sp.eye(8)
    T = tlin.SparseExplicitLinOp(A, device="cpu")
    J = jlin.SparseExplicitLinOp(A)
    assert T.trace() == pytest.approx(J.trace(), rel=1e-6)
    np.testing.assert_allclose(T.asarray().numpy(), np.asarray(J.asarray()),
                               rtol=0, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    want = x @ A.toarray().T
    dense = torch.from_numpy(A.toarray().astype(np.float32))
    for src in (A.tocoo(), A.tocsc(), dense.to_sparse(),
                dense.to_sparse_csr(), dense.to_sparse_csc()):
        S_ = tabc.LinOp.from_array(src, device="cpu")
        assert isinstance(S_, tlin.SparseExplicitLinOp)
        _close(S_.apply(_t(x)), want, np.float32)
    # the deliberate divergence: the layout is checked
    with pytest.raises(TypeError):
        tlin.SparseExplicitLinOp(A.astype(np.complex64), device="cpu")
    with pytest.raises(TypeError):
        tlin.SparseExplicitLinOp(torch.zeros(2, 3, 4).to_sparse(),
                                 device="cpu")
    with pytest.raises(TypeError):
        tlin.SparseExplicitLinOp(np.eye(3), device="cpu")
    with pytest.raises(TypeError):
        tlin.SparseExplicitLinOp(A, dim_shape=(3, 3), device="cpu")


def test_sparse_laplacian_matches_the_stencil():
    """The 5-point Laplacian as a CSR matrix against Laplacian(constant)."""
    n = 9
    d1 = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(n, n))
    lap = (sp.kron(d1, sp.eye(n)) + sp.kron(sp.eye(n), d1)).tocsr()
    T = tlin.SparseExplicitLinOp(lap, dim_shape=(n, n), codim_shape=(n, n),
                                 device="cpu")
    L = tlin.Laplacian((n, n), mode="constant")
    x = _t(np.random.default_rng(1).standard_normal((2, n, n))
           .astype(np.float32))
    _close(T.apply(x), L.apply(x).numpy(), np.float32)
    _close(T.adjoint(x), L.adjoint(x).numpy(), np.float32)


def test_kron_closed_forms():
    a = np.random.default_rng(0).standard_normal((4, 4))
    b = np.random.default_rng(1).standard_normal((3, 3))
    T = tlin.kron(tlin.ExplicitLinOp(_t(a)), tlin.ExplicitLinOp(_t(b)))
    J = jlin.kron(jlin.ExplicitLinOp(jnp.asarray(a)),
                  jlin.ExplicitLinOp(jnp.asarray(b)))
    assert T.trace() == pytest.approx(J.trace(), rel=1e-9)
    _close(T.svdvals(k=3), J.svdvals(k=3), np.float64)
    assert T.estimate_lipschitz() == pytest.approx(
        np.linalg.norm(np.kron(a, b), 2), rel=1e-9)


# ------------------------------------------------------ element-wise maps

# name -> (class name, input map onto its domain, extra constructor args)
UFUNCS = {
    "sin": ("Sin", None), "cos": ("Cos", None), "tan": ("Tan", 0.5),
    "arcsin": ("ArcSin", 0.3), "arccos": ("ArcCos", 0.3),
    "arctan": ("ArcTan", None), "sinh": ("Sinh", None),
    "cosh": ("Cosh", None), "tanh": ("Tanh", None),
    "arcsinh": ("ArcSinh", None), "arccosh": ("ArcCosh", "gt1"),
    "arctanh": ("ArcTanh", 0.3), "exp": ("Exp", None), "log": ("Log", "pos"),
    "sqrt": ("Sqrt", "pos"), "cbrt": ("Cbrt", "pos"),
    "square": ("Square", None), "gaussian": ("Gaussian", None),
    "sigmoid": ("Sigmoid", None), "softplus": ("SoftPlus", None),
    "silu": ("SiLU", None), "abs": ("Abs", None), "sign": ("Sign", None),
    "relu": ("ReLU", None), "leakyrelu": ("LeakyReLU", None),
    "clip": ("Clip", None), "softmax": ("SoftMax", None),
}
_EXTRA = {"leakyrelu": (0.1,), "clip": (-0.5, 0.7)}


def _ufunc_input(name, fdtype):
    dom = UFUNCS[name][1]
    x = np.random.default_rng(zlib.crc32(name.encode())).uniform(
        -1.5, 1.5, (2,) + S)
    if dom == "pos":
        x = np.abs(x) + 0.2
    elif dom == "gt1":
        x = np.abs(x) + 1.2
    elif isinstance(dom, float):
        x = dom * x
    return x.astype(fdtype)


def _ufunc_op(mod, name):
    return getattr(mod, UFUNCS[name][0])(S, *_EXTRA.get(name, ()))


def _ufunc_run(op, name, x, v):
    """apply on a batch, and the Jacobian at its first sample applied to v
    (differentiable maps)."""
    out = [op.apply(x)]
    if name not in ("abs", "sign", "relu", "leakyrelu", "clip"):
        out.append(op.jacobian(x[0]).apply(v))
    return out


# each map at one width, f32 and f64 by turns: one compile a width
UFUNC_WIDTH = {n: (np.float32, np.float64)[i % 2]
               for i, n in enumerate(sorted(UFUNCS))}


@pytest.mark.parametrize("fdtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_ufuncs_match_jax(fdtype):
    names = [n for n in sorted(UFUNCS) if UFUNC_WIDTH[n] == fdtype]
    xs = {n: _ufunc_input(n, fdtype) for n in names}
    v = np.random.default_rng(3).standard_normal(S).astype(fdtype)
    jops = {n: _ufunc_op(jfn, n) for n in names}
    want = jax.jit(lambda a, w: {n: _ufunc_run(jops[n], n, a[n], w)
                                 for n in names})(
        {n: jnp.asarray(x) for n, x in xs.items()}, jnp.asarray(v))
    for n in names:
        T, J = _ufunc_op(tfn, n), jops[n]
        assert type(T).__mro__[1].__name__ == type(J).__mro__[1].__name__, n
        assert (T.lipschitz, getattr(T, "diff_lipschitz", None)) == (
            J.lipschitz, getattr(J, "diff_lipschitz", None)), n
        got = _ufunc_run(T, n, _t(xs[n]), _t(v))
        assert len(got) == len(want[n])
        for g, w in zip(got, want[n]):
            _close(g, w, fdtype)


def test_ufunc_jacobians_and_functional_forms():
    x = _t(_ufunc_input("log", np.float64)[0])
    J = tfn.Log(S).jacobian(x)
    assert isinstance(J, tlin.DiagonalOp)
    _close(J._vec, 1.0 / x.numpy(), np.float64)
    # the autodiff derivative of a map declared without one
    cls = type("Cube", (tfn.ElementWiseMap,), {
        "_fn": staticmethod(lambda t: t ** 3)})
    _close(cls(S)._deriv(x), 3 * x.numpy() ** 2, np.float64)
    K = tlin.Stencil(S, [np.array([0.25, 0.5, 0.25])] * 2, [1, 1],
                     mode="symmetric")
    Kj = jlin.Stencil(S, [jnp.asarray([0.25, 0.5, 0.25])] * 2, [1, 1],
                      mode="symmetric")
    # the functional form is the map after the operator, of the JAX
    # package's class (the maps themselves are held above)
    for name in ("tanh", "softplus", "relu", "clip", "softmax"):
        t = getattr(tfn, name)(K, *_EXTRA.get(name, ()))
        j = getattr(jfn, name)(Kj, *_EXTRA.get(name, ()))
        assert type(t).__name__ == type(j).__name__
        _close(t.apply(x), _ufunc_op(tfn, name).apply(K.apply(x)),
               np.float64)
    assert type(tfn.exp(S)).__name__ == "Exp"
    # the softmax Jacobian: diag(p) - p p^T, self-adjoint
    p = tfn.SoftMax(S).apply(x)
    Js = tfn.SoftMax(S).jacobian(x).asarray(dtype=torch.float64,
                                            device="cpu").reshape(30, 30)
    pv = p.reshape(-1).numpy()
    _close(Js, np.diag(pv) - np.outer(pv, pv), np.float64)


# ----------------------------------------------------------------- filters

FILTERS = {
    "sobel": lambda L: L.Sobel(S, mode="symmetric"),
    "prewitt_3d": lambda L: L.Prewitt((3, 4, 5), mode="constant"),
    "scharr_sampling": lambda L: L.Scharr(S, sampling=(0.5, 2.0)),
    "structure": lambda L: L.StructureTensor(S, mode="symmetric"),
    "structure_gd": lambda L: L.StructureTensor(
        S, diff_method="gd", sigma=0.8, smooth_sigma=0.0),
}


FILTER_WIDTH = {n: (np.float32, np.float64)[i % 2]
                for i, n in enumerate(sorted(FILTERS))}


@pytest.mark.parametrize("fdtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_filters_match_jax(fdtype):
    ops = {n: b(jlin) for n, b in FILTERS.items()
           if FILTER_WIDTH[n] == fdtype}
    xs, vs, ws = {}, {}, {}
    for n, op in ops.items():
        rng = np.random.default_rng(zlib.crc32(n.encode()))
        xs[n] = rng.standard_normal((2,) + op.dim_shape).astype(fdtype)
        vs[n] = rng.standard_normal(op.dim_shape).astype(fdtype)
        ws[n] = rng.standard_normal(op.codim_shape).astype(fdtype)

    def run(op, x, v, w):
        Jx = op.jacobian(x[0])
        return [op.apply(x), Jx.apply(v), Jx.adjoint(w)]
    want = jax.jit(lambda a: {n: run(op, *a[n]) for n, op in ops.items()})(
        {n: [jnp.asarray(xs[n]), jnp.asarray(vs[n]), jnp.asarray(ws[n])]
         for n in ops})
    for n in ops:
        T = FILTERS[n](tlin)
        assert (T.dim_shape, T.codim_shape) == (ops[n].dim_shape,
                                                ops[n].codim_shape)
        got = run(T, _t(xs[n]), _t(vs[n]), _t(ws[n]))
        for g, w in zip(got, want[n]):
            _close(g, w, fdtype)


def test_filters_never_differentiate_a_kernel():
    """The edge magnitude's and the structure tensor's Jacobians compose
    their parts': no ``torch.func`` transform reaches the stencil."""
    from pyxu_tpu_torch.abc.operator import _JacobianOp
    x = _t(np.random.default_rng(0).standard_normal(S))
    for op in (tlin.Sobel(S, mode="symmetric"), tlin.StructureTensor(S)):
        J = op.jacobian(x)

        def walk(o, seen=()):
            assert not isinstance(o, _JacobianOp), type(o).__name__
            for v in vars(o).values():
                for m in (v if isinstance(v, tuple) else (v,)):
                    if isinstance(m, tabc.Operator) and m not in seen:
                        walk(m, seen + (o,))
        walk(J)


# ----------------------------------------------------------------- interop

def test_from_sciop_matches_jax():
    A = _csr((7, 9), 5, density=0.5).toarray()
    x = np.random.default_rng(0).standard_normal((3, 9))
    y = np.random.default_rng(1).standard_normal((3, 7))
    for wrap in (spl.aslinearoperator, lambda m: spl.LinearOperator(
            m.shape, matvec=lambda v: m @ v, rmatvec=lambda v: m.T @ v)):
        T, J = tint.from_sciop(wrap(A)), jint.from_sciop(wrap(A))
        _close(T.apply(_t(x)), J.apply(jnp.asarray(x)), np.float64)
        _close(T.adjoint(_t(y)), J.adjoint(jnp.asarray(y)), np.float64)
    assert T.apply(_t(x)).dtype == torch.float64


def test_from_torch_matches_jax(monkeypatch):
    w = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64).reshape(3, 4)

    def f_apply(x):
        return (torch.sin(x) * w).sum(dim=(-2, -1))

    def lin_apply(x):
        return torch.stack([x[..., 0, :] + 2 * x[..., 1, :], x[..., 2, :]],
                           dim=-2)
    x = np.random.default_rng(2).standard_normal((2, 3, 4))
    y = np.random.default_rng(3).standard_normal((2, 2, 4))
    for vec in ((), ("apply",)):
        Tf = tint.from_torch(tabc.DiffFunc, (3, 4), apply=f_apply,
                             vectorize=vec)
        Jf = jint.from_torch(jabc.DiffFunc, (3, 4), apply=f_apply,
                             vectorize=vec)
        _close(Tf.apply(_t(x)), Jf.apply(jnp.asarray(x)), np.float64)
        _close(Tf.grad(_t(x)), Jf.grad(jnp.asarray(x)), np.float64)
        Tl = tint.from_torch(tabc.LinOp, (3, 4), (2, 4), apply=lin_apply,
                             vectorize=vec, lipschitz=3.0)
        Jl = jint.from_torch(jabc.LinOp, (3, 4), (2, 4), apply=lin_apply,
                             vectorize=vec)
        _close(Tl.apply(_t(x)), Jl.apply(jnp.asarray(x)), np.float64)
        _close(Tl.adjoint(_t(y)), Jl.adjoint(jnp.asarray(y)), np.float64)
        assert Tl.lipschitz == 3.0
    # a callable that reaches a kernel wrapper runs through its autograd
    # rule (counted), launches no kernel on CPU tensors, and gives the
    # numbers of torch.func through the plain version
    from pyxu_tpu_torch.ops import stencil as st
    K = tlin.Stencil((16, 16), [np.array([0.25, 0.5, 0.25])] * 2, [1, 1],
                     mode="symmetric")
    g = tint.from_torch(tabc.DiffFunc, (16, 16),
                        apply=lambda t: (K.apply(t) ** 2).sum((-2, -1)))
    n0 = st.separable_correlate2d.launches
    x = _t(np.random.default_rng(4).standard_normal((16, 16)))
    c0 = st.separable_correlate2d.rule_calls["vjp"]
    got = g.grad(x)
    assert st.separable_correlate2d.rule_calls["vjp"] > c0
    assert st.separable_correlate2d.launches == n0
    monkeypatch.setattr(st, "under_autodiff", lambda *t: False)
    want = g.grad(x)                          # the plain version's graph
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    _close(g.grad(torch.ones(16, 16, dtype=torch.float64)),
           2 * K.adjoint(K.apply(torch.ones(16, 16, dtype=torch.float64))),
           np.float64)


def test_asarray_and_astensor():
    t = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    a = tint.asarray(t)
    assert isinstance(a, torch.Tensor) and not a.requires_grad
    np.testing.assert_array_equal(a.numpy(), np.asarray(jint.asarray(t)))
    n = np.arange(6.0).reshape(2, 3)
    b = tint.astensor(n)
    assert torch.equal(b, jint.astensor(jnp.asarray(n)).to(b.dtype))
    assert tint.astensor(t).data_ptr() == t.data_ptr()


# --------------------------------------------------------------- utilities

def test_misc_utilities_match_jax():
    for args in (((2, 3, 4, 5), (4, 5)), ((4, 5), ()), ((5,), (5,))):
        assert tutil.broadcast_shapes_leading(*args) == \
            jutil.broadcast_shapes_leading(*args)
    with pytest.raises(ValueError):
        tutil.broadcast_shapes_leading((2, 3), (4,))
    for a, b in ((((3, 1), (4,)), ((1, 5), (4,))), ((3, (4,)), ((), 4)),
                 (((2,), (3,)), ((2,), (4,)))):
        for fn in ("infer_sum_shape", "infer_composition_shape"):
            try:
                want = getattr(jutil, fn)(a, b)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(tutil, fn)(a, b)
            else:
                assert getattr(tutil, fn)(a, b) == want
    got = tutil.star_like_sample(32, 5, 20.0, 2, 0.7, dtype=torch.float64,
                                 device="cpu")
    _close(got, jutil.star_like_sample(32, 5, 20.0, 2, 0.7), np.float64)


@pytest.mark.parametrize("ri,ro", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_complex_mats_match_jax(ri, ro):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    R = tutil.view_as_real_mat(_t(A), real_input=ri, real_output=ro)
    _close(R, jutil.view_as_real_mat(jnp.asarray(A), real_input=ri,
                                     real_output=ro), np.float64)
    Cj = jutil.view_as_complex_mat(jnp.asarray(R.numpy()), real_input=ri,
                                   real_output=ro)
    C = tutil.view_as_complex_mat(R, real_input=ri, real_output=ro)
    _close(torch.view_as_real(C), np.stack([np.real(Cj), np.imag(Cj)], -1),
           np.float64)
    if not (ri or ro):
        assert torch.equal(C, _t(A))


def test_precision_policy_matches_jax():
    assert [w.name for w in tinfo.CWidth] == [w.name for w in jdt.CWidth]
    assert tinfo.Width.DOUBLE.complex is tinfo.CWidth.DOUBLE
    assert tinfo.CWidth.SINGLE.real is tinfo.Width.SINGLE
    assert tinfo.default_cdtype() == torch.complex64
    with tinfo.Precision(tinfo.Width.DOUBLE):
        assert tinfo.default_cdtype() == torch.complex128
        x = tinfo.coerce(np.ones(3, np.float32))
        z = tinfo.coerce(torch.ones(3, dtype=torch.complex64))
        assert (x.dtype, z.dtype) == (torch.float64, torch.complex128)
        with tinfo.EnforcePrecision(False):
            assert not tinfo.getCoerceState()
            assert tinfo.coerce(torch.ones(2)).dtype == torch.float32
        assert tinfo.getCoerceState()

        @tinfo.enforce_precision(i="arr")
        def half(arr):
            return arr / 2
        assert half(torch.ones(2, dtype=torch.float32)).dtype == \
            torch.float64
    with tinfo.lowered_matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    with tinfo.lowered_matmul_precision("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert issubclass(twarn.ShardingWarning, twarn.PyxuTpuWarning)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warnings.warn("x", twarn.ShardingWarning)
    assert rec[0].category is twarn.ShardingWarning
