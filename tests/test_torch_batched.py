"""The port's batched evaluation of homogeneous block families against the
JAX package's vmapped fast path, on the CPU.

``operator/blocks.py``'s ``_homogeneous`` against the JAX package's
verdict on the same families; the rule each block records in
``batched_path``; the four batched sites (``stack``'s apply,
``block_diag``'s apply and adjoint, a separable sum's prox) against the
JAX package's vmapped output on one numpy input with a leading batch axis,
at f32 and f64 (tolerance ``atol_for`` times the output's largest
magnitude, at least 1), and against the port's own loop over the members;
a member's prox inside a family whose members converge at different
iteration counts against its prox alone; the batched CG against
``jax.vmap`` of the JAX one; workload 5's host reads an iteration.  The
JAX side runs under one ``jax.jit`` a family and width.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.abc as jabc
import pyxu_tpu.operator as jop
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.abc as tabc
import pyxu_tpu_torch.operator as top
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.math.cg import cg_solve as j_cg
from pyxu_tpu.operator.blocks import _homogeneous as j_homogeneous
from pyxu_tpu_torch.math.cg import cg_solve as t_cg
from pyxu_tpu_torch.operator.blocks import _homogeneous as t_homogeneous


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = (6, 7)
N = 4


def _pkg(name, fdtype):
    """Both packages behind one face: ``L`` (linop), ``O`` (operator),
    ``A`` (abc), ``a`` (numpy to the package's array)."""
    if name == "jax":
        return types.SimpleNamespace(L=jlin, O=jop, A=jabc,
                                     a=lambda v: jnp.asarray(v, fdtype))
    return types.SimpleNamespace(
        L=tlin, O=top, A=tabc,
        a=lambda v: torch.from_numpy(np.asarray(v, fdtype)))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        y=rng.standard_normal((N,) + S), k=rng.uniform(0.1, 1.0, (N, 3)),
        d=rng.uniform(0.5, 2.0, (N,) + S), m=rng.standard_normal(
            (N,) + S + S) / 7)


# family -> (build(P, D), the port's batched_path, functional family)
FAMILIES = {
    "l1": (lambda P, D: [P.O.L1Norm(S) for _ in range(N)], "loop", True),
    "identity": (lambda P, D: [P.L.IdentityOp(S) for _ in range(N)], "loop",
                 False),
    "homothety": (lambda P, D: [P.L.HomothetyOp(S, 1.0 + i)
                                for i in range(N)], "loop", False),
    "asloss": (lambda P, D: [P.O.SquaredL2Norm(S).asloss(P.a(D.y[i]))
                             for i in range(N)], "quadratic", True),
    "squared_l2": (lambda P, D: [P.O.SquaredL2Norm(S) for _ in range(N)],
                   "vmap", True),
    "l1_asloss": (lambda P, D: [P.O.L1Norm(S).asloss(P.a(D.y[i]))
                                for i in range(N)], "vmap", True),
    "hyperslab": (lambda P, D: [P.O.HyperSlab(P.a(D.y[i]), -1.0, 1.0)
                                for i in range(N)], "vmap", True),
    "stencil_equal": (lambda P, D: [
        P.L.Stencil(S, [P.a(D.k[0]), P.a(D.k[1])], [1, 1], mode="symmetric")
        for _ in range(N)], "stencil", False),
    "stencil_taps": (lambda P, D: [
        P.L.Stencil(S, [P.a(D.k[i]), P.a(D.k[N - 1 - i])], [1, 1],
                    mode="symmetric") for i in range(N)], "stencil", False),
    "stencil_constant": (lambda P, D: [
        P.L.Stencil(S, [P.a(D.k[i][:2]), P.a(D.k[i])], [0, 2])
        for i in range(N)], "stencil", False),
    "stencil_lengths": (lambda P, D: [
        P.L.Stencil(S, [P.a(D.k[i][:2 + i % 2]), P.a(D.k[i])], [1, 1])
        for i in range(N)], "loop", False),
    "convolve": (lambda P, D: [
        P.L.Convolve(S, [P.a(D.k[i]), P.a(D.k[i])], [1, 1], mode="symmetric")
        for i in range(N)], "stencil", False),
    "diagonal": (lambda P, D: [P.L.DiagonalOp(P.a(D.d[i])) for i in range(N)],
                 "vmap", False),
    "explicit": (lambda P, D: [P.L.ExplicitLinOp(P.a(D.m[i]), dim_rank=2)
                               for i in range(N)], "vmap", False),
    "scaled_diagonal": (lambda P, D: [2.0 * P.L.DiagonalOp(P.a(D.d[i]))
                                      for i in range(N)], "vmap", False),
    "scales_differ": (lambda P, D: [(1.0 + i) * P.L.DiagonalOp(P.a(D.d[i]))
                                    for i in range(N)], "loop", False),
    "gradient": (lambda P, D: [P.L.Gradient(S) for _ in range(2)], "loop",
                 False),
    "quadratic_q_differs": (lambda P, D: [
        P.A.QuadraticFunc(S, Q=P.L.DiagonalOp(P.a(D.d[i])))
        for i in range(N)], "loop", True),
    "mixed_classes": (lambda P, D: [
        P.L.DiagonalOp(P.a(D.d[0])),
        P.L.ExplicitLinOp(P.a(D.m[0]), dim_rank=2)], "loop", False),
    "mixed_dtypes": (lambda P, D: [
        P.L.DiagonalOp(P.a(D.d[0])),
        P.L.DiagonalOp(P.a(D.d[1]).astype(np.float64)
                       if P.L is jlin else P.a(D.d[1]).double())],
        "loop", False),
}


def _families(name, fdtype, seed=0):
    build = FAMILIES[name][0]
    D = _data(seed)
    return (build(_pkg("jax", fdtype), D),
            build(_pkg("torch", fdtype), D))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_homogeneous_verdict_and_rule(name):
    jops, tops = _families(name, np.float64)
    assert t_homogeneous(tops) == j_homogeneous(jops)
    if name != "mixed_dtypes":
        blk = top.block_diag(tops)
        assert blk.batched_path == FAMILIES[name][1]
    if "mixed" not in name and not FAMILIES[name][2]:
        assert top.stack(tops).batched_path == FAMILIES[name][1]


def test_mixed_shapes_are_not_homogeneous():
    d = np.random.default_rng(0).uniform(0.5, 2.0, S)
    for L, a in ((jlin, jnp.asarray), (tlin, torch.from_numpy)):
        assert not (t_homogeneous if L is tlin else j_homogeneous)(
            [L.DiagonalOp(a(d)), L.DiagonalOp(a(d.T.copy()))])


def _close(got, want, fdtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_for(fdtype) * s)


def _looped(op):
    """``op`` evaluated member by member."""
    out = copy.copy(op)
    out.batched_path = "loop"
    return out


LINOP_FAMILIES = ["stencil_equal", "stencil_taps", "stencil_constant",
                  "convolve", "diagonal", "explicit", "scaled_diagonal"]
PROX_FAMILIES = ["asloss", "squared_l2", "l1_asloss", "hyperslab"]


@pytest.mark.parametrize("name", LINOP_FAMILIES)
def test_stack_and_block_diag_match_the_vmapped_jax(name, fdtype):
    jops, tops = _families(name, fdtype)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2,) + S).astype(fdtype)
    xb = rng.standard_normal((2, N) + S).astype(fdtype)
    yb = rng.standard_normal((2, N) + S).astype(fdtype)
    js, jb = jop.stack(jops), jop.block_diag(jops)
    assert js._vmap and jb._vmap
    want = jax.jit(lambda u, v, w: (js.apply(u), jb.apply(v),
                                    jb.adjoint(w)))(xs, xb, yb)
    ts, tb = top.stack(tops), top.block_diag(tops)
    assert ts.batched_path == tb.batched_path == FAMILIES[name][1]
    args = [torch.from_numpy(a) for a in (xs, xb, yb)]
    got = (ts.apply(args[0]), tb.apply(args[1]), tb.adjoint(args[2]))
    loop = (_looped(ts).apply(args[0]), _looped(tb).apply(args[1]),
            _looped(tb).adjoint(args[2]))
    for g, w, lp in zip(got, want, loop):
        assert g.dtype == lp.dtype and g.shape == lp.shape
        _close(g, w, fdtype)
        _close(g, lp.numpy(), fdtype)


@pytest.mark.parametrize("name", PROX_FAMILIES)
def test_separable_prox_matches_the_vmapped_jax(name, fdtype):
    jops, tops = _families(name, fdtype)
    x = np.random.default_rng(4).standard_normal((2, N) + S).astype(fdtype)
    jf = jop.block_diag(jops)
    assert jf._vmap
    want = jax.jit(lambda v: jf.prox(v, 0.3))(x)
    tf = top.block_diag(tops)
    assert tf.batched_path == FAMILIES[name][1]
    got = tf.prox(torch.from_numpy(x), 0.3)
    _close(got, want, fdtype)
    _close(got, _looped(tf).prox(torch.from_numpy(x), 0.3).numpy(), fdtype)


def _staggered(P, fdtype):
    """Eight QuadraticFuncs with one diagonal Q of eight distinct values and
    linear terms reaching 1-8 of them: member i's CG from 0 converges in
    i + 1 iterations."""
    q = np.zeros(S)
    q.flat[:8] = 1.0 + np.arange(8)
    q.flat[8:] = 1.0
    rng = np.random.default_rng(6)
    cs = []
    for i in range(8):
        c = np.zeros(S)
        c.flat[:i + 1] = rng.standard_normal(i + 1)
        cs.append(c)
    Q = P.L.DiagonalOp(P.a(q))
    return [P.A.QuadraticFunc(S, Q=Q, c=P.L.ExplicitLinFunc(P.a(c)))
            for c in cs]


def test_member_prox_does_not_depend_on_its_family(fdtype):
    tops = _staggered(_pkg("torch", fdtype), fdtype)
    fam = top.block_diag(tops)
    assert fam.batched_path == "quadratic"
    x = torch.zeros((8,) + S, dtype=torch.from_numpy(
        np.zeros(1, fdtype)).dtype)
    got = fam.prox(x, 0.5)
    for i, f in enumerate(tops):
        alone = f.prox(x[i], 0.5)
        _close(got[i], alone.numpy(), fdtype)
        # a family of one: the member's own loop
        one = top.block_diag([f]).prox(x[i:i + 1], 0.5)[0]
        _close(got[i], one.numpy(), fdtype)
    jops = _staggered(_pkg("jax", fdtype), fdtype)
    jf = jop.block_diag(jops)
    want = jax.jit(lambda v: jf.prox(v, 0.5))(np.zeros((8,) + S, fdtype))
    _close(got, want, fdtype)


def test_batched_cg_matches_jax_vmap(fdtype):
    """``members=True``: each member stops on its own residual, as the JAX
    loop under ``jax.vmap``; budgets above and below the check rate."""
    rng = np.random.default_rng(8)
    d = rng.uniform(1.0, 30.0, (5, 12)).astype(fdtype)
    b = rng.standard_normal((5, 12)).astype(fdtype)
    b[1] *= 1e-3
    for maxiter in (6, 40):
        want = jax.jit(jax.vmap(lambda dd, bb: j_cg(
            lambda p: dd * p, bb, rtol=1e-6, maxiter=maxiter)))(d, b)
        td = torch.from_numpy(d)
        got = t_cg(lambda p: td * p, torch.from_numpy(b), rtol=1e-6,
                   maxiter=maxiter, members=True)
        _close(got, want, fdtype)
        for i in range(5):
            alone = t_cg(lambda p: td[i] * p, torch.from_numpy(b[i]),
                         rtol=1e-6, maxiter=maxiter)
            _close(got[i], alone.numpy(), fdtype)


def test_consensus_tiles_read_the_host_once_an_iteration():
    from pyxu_tpu_torch.models import consensus_tiles
    from pyxu_tpu_torch.opt.stop import MaxIter
    from pyxu_tpu_torch.runtime import host_read
    slv, fit, _ = consensus_tiles(tile=(64, 48), n_tiles=8, device="cpu")
    assert slv._fsum.batched_path == "quadratic"
    n = 20
    r0 = host_read.count
    slv.fit(stop_crit=MaxIter(n), max_iter=n, segment_size=n, **fit)
    assert int(slv.stats()[1]["iteration"][-1]) == n
    assert (host_read.count - r0) / n <= 1.0
