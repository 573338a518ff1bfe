"""The port's derivative stack against pyxu_tpu's, on the CPU.

One numpy input goes through both packages (the JAX side under one
``jax.jit`` a width): PartialDerivative (finite differences and Gaussian
derivatives), Gradient, Jacobian, Divergence, Hessian, Laplacian and the
four directional forms with constant and per-pixel fields, each on its
apply, adjoint, declared Lipschitz constant and ``asarray``.  Then the
Hessian-Frobenius deconvolution path at 64x48 (30 CondatVu iterations, f32
and f64) against the JAX package's solve, the 2-D partials' kernel path,
and the kernel wrappers' refusal of ``torch.func``.  Tolerance:
``atol_for`` times the output's largest magnitude (at least 1).
"""

import math
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
from pyxu_tpu.models.workloads import _gauss1d
from pyxu_tpu.opt.solver import CondatVu as JCondatVu
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.abc.operator import Operator
from pyxu_tpu_torch.operator.linop.stencil import Stencil
from pyxu_tpu_torch.opt.solver import CondatVu
from pyxu_tpu_torch.opt.stop import MaxIter
from pyxu_tpu_torch.utils.misc import peaks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S2, S3 = (6, 5), (3, 4, 5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, fdtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_for(fdtype) * s)


def _field(shape, seed, fdtype):
    """A per-pixel direction field (D, *shape), away from zero."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((len(shape),) + shape)
    v[0] += 2.0
    return v.astype(fdtype)


# name -> factory(lin, dtype, device kwargs): the same call in both
# packages; ``dev`` is {} for the JAX package and {"device": "cpu"} here
CASES = {
    "pd_fd": lambda L, d, dev: L.PartialDerivative.finite_difference(
        S2, (1, 2), scheme="central", accuracy=2, mode="symmetric",
        sampling=0.5),
    "pd_gd": lambda L, d, dev: L.PartialDerivative.gaussian_derivative(
        S2, (1, 0), sigma=1.2, mode="constant"),
    "pd_gd_3d": lambda L, d, dev: L.PartialDerivative.gaussian_derivative(
        S3, (0, 1, 2), sigma=(1.0, 0.7, 0.9), truncate=2.0, mode="edge"),
    "gradient_gd": lambda L, d, dev: L.Gradient(
        S2, diff_method="gd", sigma=0.8, mode="symmetric"),
    "gradient_backward": lambda L, d, dev: L.Gradient(
        S2, scheme="backward", accuracy=2, mode="reflect", sampling=2.0),
    "jacobian": lambda L, d, dev: L.Jacobian((2,) + S2, mode="constant"),
    "jacobian_gd": lambda L, d, dev: L.Jacobian(
        (2,) + S2, diff_method="gd", sigma=1.0, mode="symmetric"),
    "divergence": lambda L, d, dev: L.Divergence((2,) + S2,
                                                 mode="symmetric"),
    "divergence_central": lambda L, d, dev: L.Divergence(
        (2,) + S2, scheme="central", mode="wrap"),
    "hessian": lambda L, d, dev: L.Hessian(S2, mode="symmetric"),
    "hessian_pair": lambda L, d, dev: L.Hessian(S2, directions=(0, 1)),
    "hessian_3d": lambda L, d, dev: L.Hessian(S3, mode="wrap"),
    "hessian_gd": lambda L, d, dev: L.Hessian(S2, diff_method="gd",
                                              sigma=1.0),
    "laplacian": lambda L, d, dev: L.Laplacian(S2, mode="constant"),
    "laplacian_1d": lambda L, d, dev: L.Laplacian((7,), mode="edge"),
    "dir_const": lambda L, d, dev: L.DirectionalDerivative(
        S2, 1, np.array([0.6, -0.8], d), **dev),
    "dir_field": lambda L, d, dev: L.DirectionalDerivative(
        S2, 1, _field(S2, 1, d), mode="symmetric", **dev),
    "dir2_const": lambda L, d, dev: L.DirectionalDerivative(
        S2, 2, np.array([1.0, 2.0], d), **dev),
    "dir2_pair": lambda L, d, dev: L.DirectionalDerivative(
        S2, 2, (_field(S2, 2, d), _field(S2, 3, d)), mode="symmetric",
        **dev),
    "dir_gradient": lambda L, d, dev: L.DirectionalGradient(
        S2, [np.array([1.0, 0.0], d), _field(S2, 4, d)], **dev),
    "dir_laplacian": lambda L, d, dev: L.DirectionalLaplacian(
        S2, [_field(S2, 5, d), np.array([1.0, 1.0], d)],
        weights=[0.5, 2.0], mode="symmetric", **dev),
    "dir_hessian": lambda L, d, dev: L.DirectionalHessian(
        S2, [np.array([1.0, 0.0], d), _field(S2, 6, d)], **dev),
}
WIDTHS = (np.float32, np.float64)
# each case at one width, f32 and f64 by turns: a width's cases go through
# one compile, and building the JAX operators is eager
WIDTH_OF = {n: WIDTHS[i % 2] for i, n in enumerate(sorted(CASES))}
_REFS = {}


def _inputs(name, fdtype, op):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal((2,) + op.dim_shape).astype(fdtype)
    y = rng.standard_normal((2,) + op.codim_shape).astype(fdtype)
    return x, y


def _basis_apply(op, fdtype):
    n = op.dim_size
    cols = op.apply(jnp.eye(n, dtype=fdtype).reshape((n,) + op.dim_shape))
    return cols.reshape(n, -1).T.reshape(op.codim_shape + op.dim_shape)


def _refs(fdtype):
    """Every case's JAX outputs at one width, through one ``jax.jit``."""
    key = np.dtype(fdtype).name
    if key not in _REFS:
        ops = {n: b(jlin, fdtype, {}) for n, b in CASES.items()
               if WIDTH_OF[n] == fdtype}
        arrs = {n: _inputs(n, fdtype, op) for n, op in ops.items()}

        def run(a):
            # asarray as the apply of the basis, one batch (the JAX
            # package's asarray vmaps the same apply)
            return {n: [op.apply(a[n][0]), op.adjoint(a[n][1]),
                        _basis_apply(op, fdtype)]
                    for n, op in ops.items()}
        outs = jax.jit(run)({n: [jnp.asarray(v) for v in arrs[n]]
                             for n in ops})
        _REFS[key] = (ops, arrs, outs)
    return _REFS[key]


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(name):
    fdtype = WIDTH_OF[name]
    jops, arrs, outs = _refs(fdtype)
    J = jops[name]
    T = CASES[name](tlin, fdtype, {"device": "cpu"})
    assert (T.dim_shape, T.codim_shape) == (J.dim_shape, J.codim_shape)
    assert type(T).__mro__[1].__name__ == type(J).__mro__[1].__name__
    x, y = arrs[name]
    want = outs[name]
    _close(T.apply(_t(x)), want[0], fdtype)
    _close(T.adjoint(_t(y)), want[1], fdtype)
    dt = torch.float64 if fdtype == np.float64 else torch.float32
    _close(T.asarray(dtype=dt, device="cpu"), want[2], fdtype)
    assert T.lipschitz == pytest.approx(J.lipschitz, rel=1e-6)


def _stencils(op, seen=None):
    """Every Stencil inside ``op``'s tree of operators."""
    seen = set() if seen is None else seen
    if id(op) in seen:
        return []
    seen.add(id(op))
    if isinstance(op, Stencil):
        return [op]
    out = []
    for v in vars(op).values():
        for m in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(m, Operator):
                out += _stencils(m, seen)
    return out


# ------------------------------------------------ the Hessian-Frobenius path

HF_SHAPE, HF_LAM, HF_ITERS = (64, 48), 2e-3, 30


def _hf_data(shape, fdtype):
    """The peaks phantom (clipped at 0, peak 1), workload 1's blur of it
    and 1% noise from ``default_rng(0)``."""
    H, W = shape
    yy, xx = np.meshgrid(np.linspace(-2.5, 2.5, H),
                         np.linspace(-2.5, 2.5, W), indexing="ij")
    x = np.clip(peaks(_t(xx), _t(yy)).numpy(), 0, None)
    x = (x / x.max()).astype(fdtype)
    n = np.random.default_rng(0).standard_normal(shape).astype(fdtype)
    return x, n


def _hf_problem(pkg, shape, fdtype):
    """(f, g, h, L, K, y) of the Hessian-Frobenius deconvolution from
    ``pkg``'s public API (``jax`` or ``torch``)."""
    x, n = _hf_data(shape, fdtype)
    k = _gauss1d(2.0, 9).astype(fdtype)
    if pkg == "jax":
        L_, O, arr = jlin, jop, jnp.asarray
    else:
        L_, O, arr = tlin, top, _t
    K = L_.Stencil(shape, [arr(k), arr(k)], [4, 4], mode="symmetric")
    y = K.apply(arr(x)) + 0.01 * arr(n)
    f = 0.5 * O.SquaredL2Norm(shape).asloss(y) * K
    g = O.PositiveOrthant(shape)
    L = O.vstack([L_.Hessian(shape, directions=(0, 0), mode="symmetric"),
                  math.sqrt(2) * L_.Hessian(shape, directions=(0, 1),
                                            mode="symmetric"),
                  L_.Hessian(shape, directions=(1, 1), mode="symmetric")])
    h = HF_LAM * O.L21Norm((3,) + shape, l2_axis=0)
    return f, g, h, L, K, y


@pytest.mark.parametrize("fdtype", WIDTHS, ids=["f32", "f64"])
def test_hessian_frobenius_path_matches_jax(fdtype):
    fj, gj, hj, Lj, _, yj = _hf_problem("jax", HF_SHAPE, fdtype)
    sj = JCondatVu(f=fj, g=gj, h=hj, K=Lj, stop_rate=10)
    sj.fit(x0=yj, stop_crit=JMaxIter(HF_ITERS), max_iter=HF_ITERS)
    f, g, h, L, K, y = _hf_problem("torch", HF_SHAPE, fdtype)
    assert L.codim_shape == (3,) + HF_SHAPE
    assert L.lipschitz == pytest.approx(Lj.lipschitz, rel=1e-6)
    slv = CondatVu(f=f, g=g, h=h, K=L, stop_rate=10)
    slv.fit(x0=y, stop_crit=MaxIter(HF_ITERS), max_iter=HF_ITERS)
    assert slv.fused_path is None
    assert (slv._tau, slv._sigma) == pytest.approx((sj._tau, sj._sigma),
                                                   rel=1e-6)
    x = slv.solution()
    assert x.dtype == y.dtype and bool((x >= 0).all())
    _close(x, sj.solution(), fdtype)
    _close(slv._mstate["z"], sj._mstate["z"], fdtype)
    # the objective went down from x0 = y
    obj = slv.objective_func
    assert float(obj({"x": x})) < float(obj({"x": y}))


def test_path_partials_take_the_kernel():
    """Every 2-D partial the path builds, and every 2-D constant or
    symmetric partial of the stack, is a Stencil on the kernel path."""
    f, g, h, L, K, y = _hf_problem("torch", (16, 12), np.float32)
    path = _stencils(L) + _stencils(K)
    assert len(path) == 4
    assert all(s.kernel_path == "kernel" for s in path)
    for name, build in CASES.items():
        for s in _stencils(build(tlin, np.float32, {"device": "cpu"})):
            want = s.dim_rank == 2 and s._mode in ("constant", "symmetric")
            assert (s.kernel_path == "kernel") == want, name


def test_wrappers_refuse_torch_func():
    """The stencil wrapper raises under ``torch.func`` and under a
    recording graph off the CPU (meta tensors stand in for the card's), and
    launches nothing."""
    from pyxu_tpu_torch.ops import stencil as st
    _, _, _, L, K, _ = _hf_problem("torch", (16, 12), np.float32)
    x = torch.zeros((16, 12), device="meta")
    n0 = st.separable_correlate2d.launches
    for op in (L, K, tlin.Laplacian((16, 12)),
               tlin.DirectionalDerivative((16, 12), 1, (1.0, 1.0),
                                          device="cpu")):
        with pytest.raises(ValueError, match="no autograd rule"):
            torch.func.jvp(op.apply, (x,), (x,))
        with pytest.raises(ValueError, match="no autograd rule"):
            op.apply(torch.zeros((16, 12), device="meta",
                                 requires_grad=True))
    assert st.separable_correlate2d.launches == n0


def test_direction_fields_are_normalised_and_kept_on_their_device():
    v = _field(S2, 7, np.float64)
    op = tlin.DirectionalDerivative(S2, 1, _t(v))
    assert op._v.device.type == "cpu"
    np.testing.assert_allclose(np.linalg.norm(op._v.numpy(), axis=0), 1.0)
    with pytest.raises(ValueError):
        tlin.DirectionalDerivative(S2, 1, np.ones((3,)), device="cpu")
    with pytest.raises(ValueError):
        tlin.DirectionalDerivative(S2, 3, np.ones((2,)), device="cpu")
