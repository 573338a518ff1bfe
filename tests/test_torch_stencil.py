"""The port's Stencil, Convolve and filter factories against pyxu_tpu, on the
CPU (where the stencil kernel's wrapper runs its plain version).

Constant mode is held against the Pallas kernel ``separable_correlate2d``
in interpret mode, called directly as ``tests/test_pallas_ops.py`` calls it;
both modes against the JAX ``Stencil`` (its XLA path).  Outputs agree
within ``atol_for`` (2e-4 at f32, 1e-8 at f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for
from test_torch_kernels import ST_TAPS, _gauss

import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.ops.pallas_stencil import separable_correlate2d as pallas_corr
from pyxu_tpu_torch.math import linalg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# an image taller than two of the kernel's tiles, and for the 9x9 taps one
# whose pad width equals its height
SHAPES = {"9x9": (4, 9)}


def _taps(name, rng):
    lh, lw, ch, cw = ST_TAPS[name]
    return ([rng.standard_normal(lh).astype(np.float32),
             rng.standard_normal(lw).astype(np.float32)], [ch, cw])


def _close(j, t, dtype):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol_for(dtype))


def _dot_test(op, rng, dtype):
    x = torch.from_numpy(rng.standard_normal(op.dim_shape).astype(dtype))
    y = torch.from_numpy(rng.standard_normal(op.codim_shape).astype(dtype))
    lhs = float(torch.sum(op.apply(x) * y))
    rhs = float(torch.sum(x * op.adjoint(y)))
    assert abs(lhs - rhs) <= 10 * atol_for(dtype) * max(1.0, abs(lhs))


def _jax_apply_adjoint(jops, xs):
    """``[(op.apply(x), op.adjoint(x)), ...]`` of the JAX operators, under
    one ``jax.jit``."""
    return jax.jit(lambda *v: [(op.apply(a), op.adjoint(a))
                               for op, a in zip(jops, v)])(*xs)


@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", sorted(ST_TAPS))
def test_stencil_matches_jax(taps, mode, rng, fdtype):
    kern, ctr = _taps(taps, rng)
    shapes = ((70, 33), SHAPES.get(taps, (6, 9)))
    jops = [jlin.Stencil(shape, [jnp.asarray(k) for k in kern], ctr,
                         mode=mode) for shape in shapes]
    xs = [rng.standard_normal((2,) + shape).astype(fdtype)
          for shape in shapes]
    want = _jax_apply_adjoint(jops, xs)     # one compile for both shapes
    for shape, x, (wa, wb) in zip(shapes, xs, want):
        top = tlin.Stencil(shape, kern, ctr, mode=mode)
        assert top.kernel_path == "kernel"
        xt = torch.from_numpy(x)
        _close(wa, top.apply(xt), fdtype)
        _close(wb, top.adjoint(xt), fdtype)
        _dot_test(top, rng, fdtype)
        if mode == "constant" and fdtype == np.float32:
            got = jax.jit(lambda v: pallas_corr(
                v, kern[0], kern[1], ctr[0], ctr[1], tile_rows=16,
                interpret=True))(x[0])
            _close(got, top.apply(xt[0]), fdtype)


def test_stencil_kernel_path_rule():
    k = _gauss()
    assert tlin.Stencil((8, 8), [k, k], [4, 4], "symmetric").kernel_path \
        == "kernel"
    assert tlin.Stencil((8, 8), [k, k], [4, 4], "wrap").kernel_path is None
    assert tlin.Stencil((8, 8, 8), [k, k, k], [4, 4, 4]).kernel_path is None
    assert tlin.Stencil((8, 8), np.outer(k, k), (4, 4)).kernel_path is None
    assert tlin.Stencil((40, 40), [np.ones(33), k], [16, 4]).kernel_path \
        is None                                       # more taps than 32
    D = tlin.Gradient((8, 8), mode="symmetric")
    assert all(op.kernel_path == "kernel" for op in D._ops)


# separable Stencils off the kernel: they run the per-axis plain correlation
_OFF_KERNEL = {"wrap": ((12, 10), "wrap"), "reflect": ((12, 10), "reflect"),
               "edge": ((12, 10), "edge"), "3d-symmetric": ((6, 7, 5),
                                                          "symmetric"),
               "3d-constant": ((6, 7, 5), "constant")}


@pytest.mark.parametrize("case", sorted(_OFF_KERNEL))
def test_separable_stencil_off_the_kernel_matches_jax(case, rng, fdtype):
    shape, mode = _OFF_KERNEL[case]
    lens, ctr = (3, 4, 2)[:len(shape)], [1, 3, 0][:len(shape)]
    kern = [rng.standard_normal(n).astype(np.float32) for n in lens]
    jop = jlin.Stencil(shape, [jnp.asarray(k) for k in kern], ctr, mode=mode)
    top = tlin.Stencil(shape, kern, ctr, mode=mode)
    assert top.kernel_path is None
    x = rng.standard_normal((2,) + shape).astype(fdtype)
    xt = torch.from_numpy(x)
    [(wa, wb)] = _jax_apply_adjoint([jop], [x])
    _close(wa, top.apply(xt), fdtype)
    _close(wb, top.adjoint(xt), fdtype)
    _dot_test(top, rng, fdtype)


@pytest.mark.parametrize("mode", ["constant", "symmetric", "wrap"])
def test_convolve_and_accessors_match_jax(mode, rng, fdtype):
    kern, ctr = _taps("4x3off", rng)
    jop = jlin.Convolve((20, 17), [jnp.asarray(k) for k in kern], ctr,
                        mode=mode)
    top = tlin.Convolve((20, 17), kern, ctr, mode=mode)
    x = rng.standard_normal((20, 17)).astype(fdtype)
    [(wa, wb)] = _jax_apply_adjoint([jop], [x])
    _close(wa, top.apply(torch.from_numpy(x)), fdtype)
    _close(wb, top.adjoint(torch.from_numpy(x)), fdtype)
    assert top.center == jop.center
    for a, b in zip(top.relative_indices, jop.relative_indices):
        np.testing.assert_array_equal(a, b)
    assert top.visualize() == jop.visualize()
    assert top.configure_dispatcher(threadsperblock=64) is top


_FILTERS = {
    "moving_average": lambda m, s: m.MovingAverage(s, (3, 5), mode="symmetric"),
    "gaussian": lambda m, s: m.Gaussian(s, sigma=(1.0, 1.5), order=(0, 1)),
    "dog": lambda m, s: m.DoG(s, low_sigma=0.8, mode="symmetric"),
    "laplace": lambda m, s: m.Laplace(s, mode="symmetric", sampling=0.5),
    "sobel": lambda m, s: m.Sobel(s, axis=1),
    "prewitt": lambda m, s: m.Prewitt(s, axis=0, mode="symmetric"),
    "scharr": lambda m, s: m.Scharr(s, axis=1, sampling=2.0),
}


@pytest.mark.parametrize("name", sorted(_FILTERS))
def test_filters_match_jax(name, rng, fdtype):
    from pyxu_tpu.operator.linop import filter as jfil
    from pyxu_tpu_torch.operator.linop import filter as tfil
    shape = (24, 19)
    jop, top = _FILTERS[name](jfil, shape), _FILTERS[name](tfil, shape)
    x = rng.standard_normal((2,) + shape).astype(fdtype)
    [(wa, wb)] = _jax_apply_adjoint([jop], [x])
    _close(wa, top.apply(torch.from_numpy(x)), fdtype)
    _close(wb, top.adjoint(torch.from_numpy(x)), fdtype)
    if name in ("moving_average", "gaussian", "sobel"):
        assert top.kernel_path == "kernel"
    if name == "sobel":
        # axis=None: the gradient magnitude, a DiffMap in both packages
        jmag, tmag = jfil.Sobel(shape), tfil.Sobel(shape)
        assert type(tmag).__mro__[1].__name__ == \
            type(jmag).__mro__[1].__name__
        _close(jax.jit(jmag.apply)(x), tmag.apply(torch.from_numpy(x)),
               fdtype)


@pytest.mark.parametrize("name", ["Sobel", "Prewitt", "Scharr"])
@pytest.mark.parametrize("axis", [(0, 1), (1,), 1.0, "0", True])
def test_edge_filters_refuse_a_non_int_axis(name, axis):
    """``axis`` is an int or None: a tuple (which the JAX package takes
    for the smoothing Stencil alone) or any other type raises a
    ValueError that names those forms."""
    from pyxu_tpu_torch.operator.linop import filter as tfil
    with pytest.raises(ValueError, match="axis must be an int or None"):
        getattr(tfil, name)((12, 9), axis=axis)
    assert getattr(tfil, name)((12, 9), axis=np.int64(1)).kernel_path \
        == "kernel"


@pytest.mark.parametrize("mode", ["constant", "symmetric"])
def test_trace_and_lipschitz_estimate_match_dense(mode):
    k = _gauss()
    shape = (13, 11)
    jop = jlin.Stencil(shape, [jnp.asarray(k)] * 2, [4, 4], mode=mode)
    top = tlin.Stencil(shape, [k, k], [4, 4], mode=mode)
    A = np.asarray(jop.asarray(dtype=np.float64)).reshape(143, 143)
    assert top.trace(device="cpu", dtype=torch.float64) == pytest.approx(
        np.trace(A), rel=1e-10)
    L = top.estimate_lipschitz(device="cpu", dtype=torch.float64)
    assert L == pytest.approx(np.linalg.norm(A, 2), rel=1e-6)
    assert top.lipschitz == L
    s = linalg.svdvals(top, k=3, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(s.numpy(),
                               np.linalg.svd(A, compute_uv=False)[:3][::-1],
                               rtol=1e-6)
    tr = linalg.hutchpp(top, m=300, device="cpu", dtype=torch.float64)
    assert tr == pytest.approx(np.trace(A), rel=0.05)
    # the rule engine's estimators: the LASSO data term's diff-Lipschitz is
    # ||K||^2 through the Gram, the L1 term's Lipschitz its closed form
    import pyxu_tpu_torch.operator.func as tfunc
    f = 0.5 * tfunc.SquaredL2Norm(shape).asloss(torch.zeros(shape)) * top
    assert f.estimate_diff_lipschitz(device="cpu", dtype=torch.float64) \
        == pytest.approx(np.linalg.norm(A, 2) ** 2, rel=1e-6)
    assert (0.3 * tfunc.L1Norm(shape)).estimate_lipschitz() == \
        pytest.approx(0.3 * np.sqrt(143))
    assert (2.0 * top).T.estimate_lipschitz(device="cpu",
                                            dtype=torch.float64) \
        == pytest.approx(2 * np.linalg.norm(A, 2), rel=1e-6)
