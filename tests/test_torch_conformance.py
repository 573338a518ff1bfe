"""Property-driven conformance checks of this slice's port operators.

A torch copy of ``tests/conformance.py``: each check follows from the
operator's declared properties (the adjoint dot test, the adjoint against
autograd, linearity, the Lipschitz inequality, ``asarray``, the power
estimate against the dense spectral norm, ``trace``, the unitary,
self-adjoint, positive-definite and idempotent identities, ``gram`` and
``cogram``, ``pinv``'s damped normal equations, ``svdvals``, the quadratic
spec, ``grad`` against autograd, ``jacobian`` against finite differences,
prox optimality and Moreau's decomposition, batch broadcasting and dtype
preservation), on single operators and on a homogeneous ``block_diag`` or
``stack`` of each batched rule of ``operator/blocks.py``.  Only the checks
an operator's properties call for are collected, so none skips.  The
dagger's apply is CG, whose code is not linear (its steps depend on the
data), so autograd cannot transpose it, as
``jax.linear_transpose`` cannot in the JAX suite; its spectrum, and the
Jacobian's, are held through ``asarray`` rather than by hundreds of
nested solves or transforms.  No JAX here: ``test_torch_core.py`` and
``test_torch_sampler.py`` hold these operators against the JAX package.
"""

import math

import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu_torch.abc as tabc
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu_torch.abc.operator import Property as P
from pyxu_tpu_torch.operator.interop.source import from_source
from pyxu_tpu_torch.operator.map.base import ConstantValued

_BATCH = (2, 1, 3)
_DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mat(shape, dt, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(dt)


def _by_matrix(cls, M):
    return from_source(cls, (M.shape[1],), (M.shape[0],),
                       apply=lambda v: v @ M.T, adjoint=lambda v: v @ M)


def _unit(dt):
    Q, _ = torch.linalg.qr(_mat((5, 5), torch.float64, 1))
    return _by_matrix(tabc.UnitOp, Q.to(dt))


def _proj(dt):
    B, C = _mat((5, 2), torch.float64, 2), _mat((5, 2), torch.float64, 3)
    return _by_matrix(tabc.ProjOp, (B @ torch.linalg.solve(C.T @ B, C.T))
                      .to(dt))


def _orth(dt):
    Q, _ = torch.linalg.qr(_mat((5, 5), torch.float64, 4))
    return _by_matrix(tabc.OrthProjOp, (Q[:, :2] @ Q[:, :2].T).to(dt))


def _jacobian(dt):
    D = from_source(tabc.DiffMap, (3, 4), (3, 4),
                    apply=lambda v: torch.tanh(v) * 2.0)
    return D.jacobian(_mat((3, 4), dt, 5))


def _stencils(n, equal=False):
    """n 2-D separable Stencils on the kernel path (symmetric mode, 3 + 4
    off-centre taps), with a tap set each or one for all."""
    ks = [np.random.default_rng(0 if equal else 20 + i).uniform(0.1, 1.0, 7)
          for i in range(n)]
    return [tlin.Stencil((6, 7), [k[:3], k[3:]], [1, 2], mode="symmetric")
            for k in ks]


def _blocks(kind, dt):
    """A homogeneous block_diag or stack of each batched rule of
    ``operator/blocks.py`` (the rule is asserted)."""
    import pyxu_tpu_torch.operator as top
    fam, path = {
        "diagonal": ([tlin.DiagonalOp(_mat((3, 4), dt, 20 + i).abs() + 0.5)
                      for i in range(3)], "vmap"),
        "explicit": ([tlin.ExplicitLinOp(_mat((2, 4), dt, 23 + i))
                      for i in range(3)], "vmap"),
        "stencil": (_stencils(3), "stencil"),
        "stencil_equal": (_stencils(3, equal=True), "stencil"),
        "quadratic": ([tfunc.SquaredL2Norm((3, 4)).asloss(_mat((3, 4), dt,
                                                               26 + i))
                       for i in range(3)], "quadratic"),
        "l1_shift": ([tfunc.L1Norm((3, 4)).asloss(_mat((3, 4), dt, 29 + i))
                      for i in range(3)], "vmap"),
    }[kind[1]]
    op = (top.stack if kind[0] == "stack" else top.block_diag)(fam)
    assert op.batched_path == path
    return op


OPS = {
    "identity": lambda dt: tlin.IdentityOp((3, 4)),
    "homothety": lambda dt: tlin.HomothetyOp((3, 4), -1.5),
    "diagonal": lambda dt: tlin.DiagonalOp(_mat((3, 4), dt, 6).abs() + 0.5),
    "explicit": lambda dt: tlin.ExplicitLinOp(_mat((3, 2, 4), dt, 7)),
    "unit": _unit,
    "proj": _proj,
    "orth_proj": _orth,
    "dagger": lambda dt: tlin.ExplicitLinOp(_mat((3, 4), dt, 8)).dagger(0.1),
    "jacobian": _jacobian,
    "argscale": lambda dt: tlin.ExplicitLinOp(_mat((4, 4), dt, 9))
    .argscale(-0.5),
    "power": lambda dt: tlin.ExplicitLinOp(_mat((4, 4), dt, 10) / 2) ** 3,
    "moreau_l1": lambda dt: tfunc.L1Norm((3, 4)).moreau_envelope(0.4),
    "l2": lambda dt: tfunc.L2Norm((3, 4)),
    "squared_l1": lambda dt: tfunc.SquaredL1Norm((3, 4)),
    "squared_l1_root": lambda dt: tfunc.SquaredL1Norm((3, 4), "root"),
    "linf": lambda dt: tfunc.LInfinityNorm((3, 4)),
    "positive_l1": lambda dt: tfunc.PositiveL1Norm((3, 4)),
    "constant": lambda dt: ConstantValued((3, 4), (), 1.5),
    "shift_loss": lambda dt: tfunc.shift_loss(tfunc.SquaredL2Norm((3, 4)),
                                              _mat((3, 4), dt, 11)),
}
OPS.update({f"{how}_{kind}": (lambda dt, key=(how, kind): _blocks(key, dt))
            for how, kind in (("block_diag", "diagonal"),
                              ("stack", "explicit"),
                              ("block_diag", "stencil"),
                              ("stack", "stencil"),
                              ("block_diag", "stencil_equal"),
                              ("block_diag", "quadratic"),
                              ("block_diag", "l1_shift"))})


def _small(op, n=512):
    return op.dim_size <= n and op.codim_size <= n


# check name -> (needs, f64 only)
CHECKS = {
    "batch_broadcast": (lambda op: True, False),
    "dtype_preserved": (lambda op: True, False),
    "lipschitz": (lambda op: math.isfinite(op.lipschitz), False),
    "linearity": (lambda op: op.has(P.LINEAR), False),
    "adjoint_dot": (lambda op: op.has(P.LINEAR), False),
    "adjoint_matches_autograd": (lambda op: op.has(P.LINEAR), False),
    "asarray_consistency": (lambda op: op.has(P.LINEAR) and _small(op),
                            False),
    "estimate_lipschitz_tight": (lambda op: op.has(P.LINEAR) and _small(op),
                                 True),
    "square_trace": (lambda op: op.has(P.LINEAR_SQUARE) and _small(op),
                     False),
    "unitary": (lambda op: op.has(P.LINEAR_UNITARY), False),
    "self_adjoint": (lambda op: op.has(P.LINEAR_SELF_ADJOINT), False),
    "posdef": (lambda op: op.has(P.LINEAR_POSITIVE_DEFINITE), False),
    "idempotent": (lambda op: op.has(P.LINEAR_IDEMPOTENT), False),
    "gram_cogram": (lambda op: op.has(P.LINEAR) and _small(op), False),
    "pinv_normal_equations": (lambda op: op.has(P.LINEAR) and _small(op, 256),
                              True),
    "svdvals_vs_dense": (lambda op: op.has(P.LINEAR) and _small(op, 256),
                         True),
    "quad_spec": (lambda op: op.has(P.QUADRATIC), False),
    "grad_matches_autograd": (lambda op: op.has(P.DIFFERENTIABLE_FUNCTION),
                              False),
    "jacobian_linearises": (lambda op: op.has(P.DIFFERENTIABLE)
                            and not op.has(P.LINEAR), True),
    "prox_optimality": (lambda op: op.has(P.PROXIMABLE), False),
    "fenchel_prox_moreau": (lambda op: op.has(P.PROXIMABLE), False),
}

_SPECTRAL = {"estimate_lipschitz_tight", "svdvals_vs_dense"}
_SKIP = {"dagger": _SPECTRAL | {"adjoint_matches_autograd"},
         "jacobian": _SPECTRAL}
CASES = [(name, check, dname)
         for name, op in ((n, build(torch.float64)) for n, build in OPS.items())
         for check, (needs, f64_only) in CHECKS.items()
         if needs(op) and check not in _SKIP.get(name, ())
         for dname in (("f64",) if f64_only else ("f32", "f64"))]


def _point(op, rng, dt, scale=1.0):
    return torch.from_numpy(rng.standard_normal(op.dim_shape) * scale).to(dt)


def _copoint(op, rng, dt):
    return torch.from_numpy(rng.standard_normal(op.codim_shape)).to(dt)


def _dot(a, b):
    return float(torch.sum(a.double() * b.double()))


def _allclose(a, b, atol):
    return bool(torch.allclose(torch.as_tensor(a).double(),
                               torch.as_tensor(b).double(), rtol=1e-5,
                               atol=atol))


def _dense(op, dt):
    return op.asarray(dtype=dt, device="cpu").reshape(op.codim_size,
                                                     op.dim_size)


@pytest.mark.parametrize("name,check,dname", CASES,
                         ids=[f"{n}-{c}-{d}" for n, c, d in CASES])
def test_conformance(name, check, dname):
    dt = _DTYPES[dname]
    op = OPS[name](dt)
    rng = np.random.default_rng(17)
    tol = atol_for(np.float32 if dt == torch.float32 else np.float64)
    globals()[f"_check_{check}"](op, rng, dt, tol)


def _check_batch_broadcast(op, rng, dt, tol):
    x = _point(op, rng, dt)
    yb = op.apply(x.expand(_BATCH + x.shape).contiguous())
    y = op.apply(x)
    assert yb.shape == _BATCH + y.shape
    assert _allclose(yb[0, 0, 0], y, tol * 10)


def _check_dtype_preserved(op, rng, dt, tol):
    assert op.apply(_point(op, rng, dt)).dtype == dt


def _check_lipschitz(op, rng, dt, tol):
    L = op.lipschitz
    for _ in range(5):
        x, y = _point(op, rng, dt), _point(op, rng, dt)
        lhs = float(torch.linalg.vector_norm(op.apply(x) - op.apply(y)))
        rhs = L * float(torch.linalg.vector_norm(x - y))
        assert lhs <= rhs * (1 + 1e-3) + tol * 10


def _check_linearity(op, rng, dt, tol):
    x, y = _point(op, rng, dt), _point(op, rng, dt)
    assert _allclose(op.apply(2.5 * x - 1.5 * y),
                     2.5 * op.apply(x) - 1.5 * op.apply(y), tol * 100)


def _check_adjoint_dot(op, rng, dt, tol):
    for _ in range(5):
        x, y = _point(op, rng, dt), _copoint(op, rng, dt)
        lhs, rhs = _dot(op.apply(x), y), _dot(x, op.adjoint(y))
        ref = max(abs(lhs), abs(rhs), 1.0)
        assert abs(lhs - rhs) <= (1e-3 if dt == torch.float32 else 1e-8) * ref


def _check_adjoint_matches_autograd(op, rng, dt, tol):
    y = _copoint(op, rng, dt)
    got = op.adjoint(y)
    want = tabc.LinOp.adjoint(op, y)           # the vjp of the linear apply
    assert _allclose(got, want, tol * 100)


def _check_asarray_consistency(op, rng, dt, tol):
    A = _dense(op, dt).double()
    x = _point(op, rng, dt)
    want = (A @ x.double().reshape(-1)).reshape(op.codim_shape)
    assert _allclose(op.apply(x), want, tol * 100)


def _check_estimate_lipschitz_tight(op, rng, dt, tol):
    true = float(torch.linalg.matrix_norm(_dense(op, dt), ord=2))
    est = op.estimate_lipschitz(method="power", maxiter=256, dtype=dt,
                                device="cpu")
    assert true * (1 - 1e-4) - 1e-9 <= est <= true * (1 + 1e-2) + 1e-9


def _check_square_trace(op, rng, dt, tol):
    want = float(torch.trace(_dense(op, dt).double()))
    assert abs(op.trace(dtype=dt, device="cpu") - want) <= \
        tol * max(1.0, abs(want))


def _check_unitary(op, rng, dt, tol):
    x = _point(op, rng, dt)
    assert _allclose(op.adjoint(op.apply(x)), x, tol * 100)


def _check_self_adjoint(op, rng, dt, tol):
    x = _point(op, rng, dt)
    assert _allclose(op.apply(x), op.adjoint(x), tol * 10)


def _check_posdef(op, rng, dt, tol):
    x = _point(op, rng, dt)
    assert _dot(x, op.apply(x)) > 0


def _check_idempotent(op, rng, dt, tol):
    y = op.apply(_point(op, rng, dt))
    assert _allclose(op.apply(y), y, tol * 100)


def _check_gram_cogram(op, rng, dt, tol):
    x, y = _point(op, rng, dt), _copoint(op, rng, dt)
    g, cg = op.gram(), op.cogram()
    assert _allclose(g.apply(x), op.adjoint(op.apply(x)), tol * 100)
    assert _allclose(cg.apply(y), op.apply(op.adjoint(y)), tol * 100)
    assert _allclose(g.apply(x), g.adjoint(x), tol * 100)
    assert _dot(x, g.apply(x)) >= -tol * 100


def _check_pinv_normal_equations(op, rng, dt, tol):
    damp = 0.1
    y = _copoint(op, rng, dt)
    xhat = op.pinv(y, damp=damp)
    lhs = op.adjoint(op.apply(xhat)) + damp * xhat
    rhs = op.adjoint(y)
    assert _allclose(lhs, rhs, 1e-5 * max(float(rhs.abs().max()), 1.0))


def _check_svdvals_vs_dense(op, rng, dt, tol):
    true = torch.linalg.svdvals(_dense(op, dt))
    k = min(2, op.dim_size, op.codim_size)
    got = torch.sort(torch.as_tensor(op.svdvals(
        k=k, maxiter=512, dtype=dt, device="cpu")).double(),
        descending=True).values
    assert abs(float(got[0]) - float(true[0])) <= 1e-2 * float(true[0]) + 1e-8
    assert float(got[-1]) <= float(true[0]) * (1 + 1e-6) + 1e-9


def _check_quad_spec(op, rng, dt, tol):
    Q, c, t = op._quad_spec()
    x = _point(op, rng, dt)
    want = 0.5 * _dot(x, Q.apply(x)) + float(c.apply(x)) + float(t)
    assert abs(float(op.apply(x)) - want) <= tol * 100 * max(1, abs(want))


def _check_grad_matches_autograd(op, rng, dt, tol):
    x = _point(op, rng, dt)
    with torch.enable_grad():
        v = x.clone().requires_grad_(True)
        out = op.apply(v).sum()
        # a constant's value does not depend on v: its gradient is 0
        want = torch.autograd.grad(out, v)[0] if out.requires_grad \
            else torch.zeros_like(x)
    assert _allclose(op.grad(x), want, tol * 100)


def _check_jacobian_linearises(op, rng, dt, tol):
    x, v = _point(op, rng, dt), _point(op, rng, dt)
    eps = 1e-6
    fd = (op.apply(x + eps * v) - op.apply(x - eps * v)) / (2 * eps)
    assert torch.allclose(op.jacobian(x).apply(v), fd, atol=1e-4, rtol=1e-4)


def _check_prox_optimality(op, rng, dt, tol):
    tau = 0.7
    x = _point(op, rng, dt)
    p = op.prox(x, tau)

    def F(u):
        return float(tau * op.apply(u) + 0.5 * torch.sum((u - x) ** 2))

    fp = F(p)
    assert math.isfinite(fp)
    for _ in range(5):
        assert fp <= F(p + 0.1 * _point(op, rng, dt)) + tol * 100


def _check_fenchel_prox_moreau(op, rng, dt, tol):
    x = _point(op, rng, dt)
    sigma = 1.3
    want = x - sigma * op.prox(x / sigma, 1.0 / sigma)
    assert _allclose(op.fenchel_prox(x, sigma), want, tol * 100)
