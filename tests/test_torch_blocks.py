"""The port's block operators against pyxu_tpu's, on the CPU.

``stack``, ``vstack``, ``hstack``, ``block_diag`` (of operators, and of
functionals as a separable sum with its prox and gradient), ``block`` and
``coo_block`` over Stencils (on the kernel path), dense and diagonal
operators and a SubSample: apply, adjoint, declared Lipschitz constant and
``asarray``, and the class the rule engine infers, each against the JAX
package's (its side under one ``jax.jit`` a width).  Tolerance:
``atol_for`` times the output's largest magnitude (at least 1).
"""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator as jop
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator as top
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.abc.operator import Property as JProperty
from pyxu_tpu.abc.operator import infer_operator_class as j_infer
from pyxu_tpu_torch.abc.operator import Property as TProperty
from pyxu_tpu_torch.abc.operator import infer_operator_class as t_infer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = (4, 5)
K3 = np.array([0.25, 0.5, 0.25])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, fdtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_for(fdtype) * s)


def _pkg(name, fdtype):
    """The two packages behind one face: ``L`` (linop), ``O`` (operator),
    ``a`` (numpy to the package's array), ``dev`` (constructor device)."""
    if name == "jax":
        return types.SimpleNamespace(L=jlin, O=jop, dev={},
                                     a=lambda v: jnp.asarray(v, fdtype))
    return types.SimpleNamespace(L=tlin, O=top, dev={"device": "cpu"},
                                 a=lambda v: _t(np.asarray(v, fdtype)))


def _members(P, seed=0):
    """Operators on (4, 5): a symmetric-mode Stencil, a dense operator, a
    diagonal one and the Hessian's cross partial."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(S + S) / 5
    d = rng.uniform(-1.0, 2.0, S)
    return [P.L.Stencil(S, [P.a(K3), P.a(K3)], [1, 1], mode="symmetric"),
            P.L.ExplicitLinOp(P.a(m), dim_rank=2),
            P.L.DiagonalOp(P.a(d)),
            P.L.Hessian(S, directions=(0, 1), mode="constant")]


def _vec(P, op, seed):
    """A 1-D view of ``op`` for the grid blocks: its dense matrix."""
    return P.L.ExplicitLinOp(P.a(np.random.default_rng(seed).standard_normal(
        op)), dim_rank=1)


CASES = {
    "stack": lambda P: P.O.stack(_members(P)[:3]),
    "vstack": lambda P: P.O.vstack(_members(P)[3:] + [
        P.O.stack(_members(P, 1)[:2])]),
    "hstack": lambda P: P.O.hstack([P.O.stack(_members(P)[:2]).T,
                                    P.O.stack(_members(P, 2)[1:3]).T]),
    "block_diag": lambda P: P.O.block_diag(_members(P)[:3]),
    "block": lambda P: P.O.block([[_vec(P, (3, 4), 1), None,
                                   _vec(P, (3, 2), 2)],
                                  [_vec(P, (5, 4), 3), _vec(P, (5, 6), 4),
                                   None]]),
    "coo_block": lambda P: P.O.coo_block(
        {(0, 0): _members(P)[0], (1, 1): _vec(P, (9, 6), 5),
         (1, 0): P.L.SubSample(S, [0, 2, 2], slice(None, None, 2))},
        (2, 2)),
}
WIDTH_OF = {n: (np.float32, np.float64)[i % 2]
            for i, n in enumerate(sorted(CASES))}
_REFS = {}


def _basis_apply(op, fdtype):
    n = op.dim_size
    cols = op.apply(jnp.eye(n, dtype=fdtype).reshape((n,) + op.dim_shape))
    return cols.reshape(n, -1).T.reshape(op.codim_shape + op.dim_shape)


def _inputs(name, op, fdtype):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.standard_normal((2,) + op.dim_shape).astype(fdtype),
            rng.standard_normal((2,) + op.codim_shape).astype(fdtype))


def _refs(fdtype):
    key = np.dtype(fdtype).name
    if key not in _REFS:
        P = _pkg("jax", fdtype)
        ops = {n: b(P) for n, b in CASES.items() if WIDTH_OF[n] == fdtype}
        arrs = {n: _inputs(n, op, fdtype) for n, op in ops.items()}
        outs = jax.jit(lambda a: {
            n: [op.apply(a[n][0]), op.adjoint(a[n][1]),
                _basis_apply(op, fdtype)] for n, op in ops.items()})(
            {n: [jnp.asarray(v) for v in arrs[n]] for n in ops})
        _REFS[key] = (ops, arrs, outs)
    return _REFS[key]


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_operator_matches_jax(name):
    fdtype = WIDTH_OF[name]
    jops, arrs, outs = _refs(fdtype)
    J, T = jops[name], CASES[name](_pkg("torch", fdtype))
    assert (T.dim_shape, T.codim_shape) == (J.dim_shape, J.codim_shape)
    assert t_infer(T.properties()).__name__ == \
        j_infer(J.properties()).__name__
    x, y = arrs[name]
    _close(T.apply(_t(x)), outs[name][0], fdtype)
    _close(T.adjoint(_t(y)), outs[name][1], fdtype)
    dt = torch.float64 if fdtype == np.float64 else torch.float32
    _close(T.asarray(dtype=dt, device="cpu"), outs[name][2], fdtype)
    assert T.lipschitz == pytest.approx(J.lipschitz, rel=1e-5)


def test_block_members_keep_the_kernel_path():
    P = _pkg("torch", np.float32)
    T = top.block_diag(_members(P)[:3])
    assert [getattr(o, "kernel_path", None) for o in T._ops] == \
        ["kernel", None, None]
    V = CASES["vstack"](P)
    assert V._ops[0]._ops[0].kernel_path == "kernel"


# ---------------------------------------------- separable sums of functionals

FUNCS = {
    "prox": lambda P: [P.O.L1Norm(S), 0.5 * P.O.SquaredL2Norm(S),
                       P.O.PositiveOrthant(S)],
    "quadratic": lambda P: [P.O.SquaredL2Norm(S),
                            2.0 * P.O.SquaredL2Norm(S).asloss(
                                P.a(np.linspace(-1, 1, 20).reshape(S)))],
    "diff": lambda P: [P.O.SquaredL2Norm(S) * P.L.Stencil(
        S, [P.a(K3), P.a(K3)], [1, 1], mode="symmetric"),
        P.O.SquaredL2Norm(S)],
    "mixed": lambda P: [P.O.L21Norm(S, l2_axis=0), P.O.L2Norm(S),
                        P.O.SquaredL2Norm(S)],
}


def _run_sum(op, a, P):
    """apply, and prox and grad where the class has them (``P``: the
    package's Property)."""
    out = [op.apply(a)]
    if op.has(P.PROXIMABLE):
        out.append(op.prox(a, 0.3))
    if op.has(P.DIFFERENTIABLE_FUNCTION):
        out.append(op.grad(a))
    return out


_SUM_REFS = {}


def _sum_refs(fdtype):
    """Every separable sum's JAX outputs at one width, one ``jax.jit``."""
    key = np.dtype(fdtype).name
    if key not in _SUM_REFS:
        P = _pkg("jax", fdtype)
        ops = {n: jop.block_diag(b(P)) for n, b in FUNCS.items()}
        xs = {n: np.random.default_rng(zlib.crc32(n.encode())).standard_normal(
            (2,) + op.dim_shape).astype(fdtype) for n, op in ops.items()}
        outs = jax.jit(lambda a: {n: _run_sum(op, a[n], JProperty)
                                  for n, op in ops.items()})(
            {n: jnp.asarray(v) for n, v in xs.items()})
        _SUM_REFS[key] = (ops, xs, outs)
    return _SUM_REFS[key]


@pytest.mark.parametrize("fdtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_separable_sum_matches_jax(name, fdtype):
    ops, xs, outs = _sum_refs(fdtype)
    J = ops[name]
    T = top.block_diag(FUNCS[name](_pkg("torch", fdtype)))
    assert type(T).__name__ == type(J).__name__
    assert t_infer(T.properties()).__name__ == \
        j_infer(J.properties()).__name__
    got, want = _run_sum(T, _t(xs[name]), TProperty), outs[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, fdtype)


def test_shape_mismatches_raise():
    P = _pkg("torch", np.float32)
    a = _members(P)[0]
    b = tlin.Hessian((4, 6))
    for fn in (top.stack, top.vstack, top.hstack, top.block_diag):
        with pytest.raises(ValueError):
            fn([a, b])
    with pytest.raises(ValueError):
        top.coo_block({(0, 0): a}, (1, 2))
