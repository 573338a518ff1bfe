"""The port's X-ray transforms, the weighted and shifted NUFFT Toeplitz
gram, and the sparse-view CT solve against pyxu_tpu, on the CPU.

One numpy input goes through both packages (the JAX side under
``jax.jit``).  ``tests/conftest.py`` turns on x64 for the JAX package, so
its Toeplitz kernels are built to ``min(eps, 1e-9)`` in float64 while the
port's float32 plan builds them at eps: the float32 grams differ by about
eps of their largest value.  Tolerances: the Toeplitz gram 1e-5 relative
at float32; FourierRadon 1e-5 relative at float32, at float64 1e-8
against the direct Fourier-slice sum and 1e-7 against the JAX package;
``_FourierRadonGram`` 2e-4 relative against the dense ``R^T R`` and
against the JAX package's gram; RadonTransform 1e-5 relative; the CT
iterates atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.operator.linop.nufft as jnu
from pyxu_tpu.models.workloads import sparse_view_ct as jsparse_view_ct
from pyxu_tpu.operator.linop.xray import FourierRadon as JFourierRadon
from pyxu_tpu.operator.linop.xray import RadonTransform as JRadonTransform
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop.nufft as tnu
from pyxu_tpu_torch.convert import ct_problem
from pyxu_tpu_torch.models import sparse_view_ct
from pyxu_tpu_torch.operator.linop.xray import (
    FourierRadon,
    RadonTransform,
    _FourierRadonGram,
)
from pyxu_tpu_torch.opt.solver import PD3O
from pyxu_tpu_torch.opt.stop import MaxIter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, the suite's workers
    share the machine's cores, and a process's first multi-threaded CPU
    ``index_add_`` has been seen to sum wrong (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tdt(fdtype):
    return torch.from_numpy(np.zeros(0, fdtype)).dtype


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def _angles(n):
    return np.linspace(0, np.pi, n, endpoint=False)


# ------------------------------------------------ the Toeplitz arguments ---

TOEPLITZ_CASES = {
    # weights and scale, complex modes
    "weights": dict(real_in=False, scale=0.25, weights=True),
    # weights and scale on the rfft half spectrum
    "weights-real": dict(real_in=True, scale=0.25, weights=True),
    # a Hankel kernel shift on one axis, ones as weights
    "shift": dict(real_in=True, scale=0.5, kernel_shift=(-1, 0)),
}


@pytest.mark.parametrize("case", sorted(TOEPLITZ_CASES))
def test_toeplitz_scale_weights_shift_match_jax(case):
    kw = dict(TOEPLITZ_CASES[case])
    rng = np.random.default_rng(4)
    N, M = (10, 9), 300
    x = rng.uniform(-np.pi, np.pi, (M, 2))
    if kw.pop("weights", False):
        kw["weights"] = rng.uniform(0.2, 1.0, M)
    jT = jnu._NUFFTToeplitz(x, N, 1, 1e-6, **kw)
    tT = tnu._NUFFTToeplitz(tnu._points(x, "cpu"), N, 1, 1e-6,
                            dtype=torch.float32, **kw)
    shape = N if kw["real_in"] else N + (2,)
    v = rng.standard_normal((2,) + shape).astype(np.float32)
    want = np.asarray(jax.jit(jT.apply)(jnp.asarray(v)))
    got = tT.apply(torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    assert tT.lipschitz == pytest.approx(jT.lipschitz, rel=1e-5)
    assert tT.trace() == pytest.approx(jT.trace(), rel=1e-5)
    np.testing.assert_array_equal(tT.adjoint(torch.from_numpy(v)).numpy(),
                                  got)


def test_shifted_toeplitz_takes_real_inputs_only():
    x = tnu._points(np.zeros((4, 2)), "cpu")
    with pytest.raises(ValueError, match="real_in"):
        tnu._NUFFTToeplitz(x, (6, 6), 1, 1e-6, kernel_shift=(-1, -1))


# ------------------------------------------------------------ FourierRadon --

def _fourier_slice(img, angles, n_det):
    """The Fourier-slice sum of FourierRadon's docstring, directly (host
    float64)."""
    H, W = img.shape
    q = np.fft.fftfreq(n_det) * 2 * np.pi
    ks = np.stack(np.meshgrid(np.arange(-(H // 2), (H + 1) // 2),
                              np.arange(-(W // 2), (W + 1) // 2),
                              indexing="ij"), -1).reshape(-1, 2)
    dirs = np.stack([np.cos(angles), np.sin(angles)], 1)
    phat = np.exp(-1j * q[None, :, None] * (dirs @ ks.T)[:, None, :]) \
        @ img.reshape(-1).astype(np.float64)
    return np.fft.ifft(phat * np.exp(-1j * q * (n_det - 1) / 2.0)).real


@pytest.mark.parametrize("fdtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_fourier_radon_matches_jax(fdtype):
    """10x10, n_det 16, 5 angles: apply and adjoint against the JAX
    package, the apply against the direct Fourier-slice sum, and <R x, y>
    = <x, R^T y>.  The JAX package keeps its detector phase in complex64,
    which holds its float64 transform to ~1e-8."""
    rng = np.random.default_rng(3)
    HW, nd, ang = (10, 10), 16, _angles(5)
    img = rng.standard_normal(HW).astype(fdtype)
    sino = rng.standard_normal((5, nd)).astype(fdtype)
    jR = JFourierRadon(HW, ang, n_det=nd, eps=1e-9)
    R = FourierRadon(HW, ang, n_det=nd, eps=1e-9, dtype=_tdt(fdtype),
                     device="cpu")
    assert R.codim_shape == (5, nd) and R.kernel_path == "kernel"
    got = R.apply(torch.from_numpy(img)).numpy()
    back = R.adjoint(torch.from_numpy(sino)).numpy()
    assert got.dtype == back.dtype == fdtype
    tol, tol_jax = (1e-5, 1e-5) if fdtype == np.float32 else (1e-8, 1e-7)
    assert _rel(got, _fourier_slice(img, ang, nd)) <= tol
    assert _rel(got, jax.jit(jR.apply)(jnp.asarray(img))) <= tol_jax
    assert _rel(back, jax.jit(jR.adjoint)(jnp.asarray(sino))) <= tol_jax
    lhs, rhs = float(np.vdot(got, sino)), float(np.vdot(img, back))
    assert lhs == pytest.approx(rhs, rel=tol)
    assert R.lipschitz == jR.lipschitz


# the parity cases of tests/test_xray_models.py: even image and detector
# (the Nyquist Hankel section), odd detector (Toeplitz alone), odd image
# axes with an even detector, mixed image parity
GRAM_CASES = [((12, 12), 16, 7), ((10, 14), 17, 5), ((9, 11), 12, 4),
              ((10, 11), 8, 6)]


@pytest.mark.parametrize("HW,nd,nang", GRAM_CASES,
                         ids=["even", "odd-det", "odd-image", "mixed"])
def test_fourier_radon_gram_matches_dense_and_jax(HW, nd, nang):
    """float32: R^T R by Toeplitz and Hankel sections against the dense
    composition R^T (R e_i) and against the JAX package's gram."""
    ang = _angles(nang)
    R = FourierRadon(HW, ang, n_det=nd, eps=1e-7, dtype=torch.float32,
                     device="cpu")
    G = R.gram()
    assert isinstance(G, _FourierRadonGram)
    assert (G._h is not None) == (nd % 2 == 0)
    n = G.dim_size
    eye = torch.eye(n, dtype=torch.float32).reshape((n,) + HW)
    Gm = G.apply(eye).reshape(n, n).numpy()
    dense = R.adjoint(R.apply(eye)).reshape(n, n).numpy()
    scale = float(np.abs(dense).max())
    assert float(np.abs(Gm - dense).max()) <= 2e-4 * scale
    assert float(np.abs(Gm - Gm.T).max()) <= 2e-4 * scale
    jG = JFourierRadon(HW, ang, n_det=nd, eps=1e-7).gram()
    want = np.asarray(jax.jit(jax.vmap(jG.apply))(jnp.asarray(eye.numpy())))
    assert float(np.abs(Gm - want.reshape(n, n)).max()) <= 2e-4 * scale
    assert G.lipschitz == pytest.approx(jG.lipschitz, rel=1e-5)


def test_fourier_radon_gram_in_the_quadratic_chain():
    """``0.5 ||R . - y||^2`` routes its Q through ``R.gram()``: once the
    constant gradient R^T y is cached, a gradient runs no spread and no
    interp; a batched gram apply matches the single ones."""
    HW, ang = (12, 12), _angles(9)
    rng = np.random.default_rng(1)
    R = FourierRadon(HW, ang, eps=1e-6, dtype=torch.float32, device="cpu")
    y = R.apply(torch.from_numpy(rng.random(HW, np.float32)))
    fq = 0.5 * tfunc.SquaredL2Norm(R.codim_shape).asloss(y) * R
    leaf = fq._quad_spec()[0]
    while hasattr(leaf, "_op"):
        leaf = leaf._op
    assert isinstance(leaf, _FourierRadonGram)
    xt = torch.from_numpy(rng.random(HW, np.float32))
    want = R.adjoint(R.apply(xt) - y)
    fq.grad(xt)                          # caches R^T y
    t1 = R._nufft._t1op

    def refuse(*args):
        raise AssertionError("a spread or interp in the gradient")
    t1._spread, t1._interp = refuse, refuse
    got = fq.grad(xt)
    assert _rel(got, want) < 1e-3
    G = R.gram()
    xb = torch.from_numpy(rng.random((3,) + HW, np.float32))
    out = G.apply(xb)
    assert out.shape == (3,) + HW
    assert float((out[1] - G.apply(xb[1])).abs().max()) < 1e-5


# ---------------------------------------------------------- RadonTransform --

@pytest.mark.parametrize("fdtype,chunk", [(np.float32, None),
                                           (np.float64, None),
                                           (np.float32, 2 * 23 * 23)],
                         ids=["f32", "f64", "f32-2-views-a-block"])
def test_radon_transform_matches_jax(fdtype, chunk, monkeypatch):
    """16x16, 6 angles: the bilinear gather and its transpose, all views in
    one block of coordinates, or (``chunk``) two views a block."""
    rng = np.random.default_rng(2)
    HW, ang = (16, 16), _angles(6)
    jR = JRadonTransform(HW, ang)
    if chunk is not None:
        monkeypatch.setattr(RadonTransform, "_CHUNK", chunk)
    R = RadonTransform(HW, ang, dtype=_tdt(fdtype), device="cpu")
    assert len(list(R._blocks())) == (3 if chunk else 1)
    img = rng.standard_normal(HW).astype(fdtype)
    sino = rng.standard_normal(R.codim_shape).astype(fdtype)
    got = R.apply(torch.from_numpy(img)).numpy()
    back = R.adjoint(torch.from_numpy(sino)).numpy()
    assert got.dtype == back.dtype == fdtype
    assert _rel(got, jax.jit(jR.apply)(jnp.asarray(img))) <= 1e-5
    assert _rel(back, jax.jit(jR.adjoint)(jnp.asarray(sino))) <= 1e-5
    assert float(np.vdot(got, sino)) == pytest.approx(
        float(np.vdot(img, back)), rel=1e-5)
    assert R.lipschitz == pytest.approx(jR.lipschitz, rel=1e-12)


# ------------------------------------------------------------ the CT slice --

@pytest.mark.parametrize("method", ["fourier", "interp"])
def test_sparse_view_ct_matches_jax(method):
    """32x32, 12 angles: the factories draw the same problem; 50 PD3O
    iterations of ``convert.ct_problem`` (the JAX problem's y and ||A||
    carried across) and of the port's factory agree with the JAX
    package's."""
    iters = 50
    jslv, jfit, jex = jsparse_view_ct((32, 32), n_angles=12, method=method)
    jslv.fit(stop_crit=JMaxIter(iters), max_iter=iters, **jfit)
    want = np.asarray(jslv.solution())
    jy = np.asarray(jex["y"]).astype(np.float32)
    f, g, h, K, slv, fit = ct_problem(jy, _angles(12), (32, 32),
                                      method=method,
                                      lipschitz=jex["A"].lipschitz,
                                      device="cpu", stop_rate=iters)
    assert isinstance(slv, PD3O) and fit["x0"].dtype == torch.float32
    slv.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit)
    assert (slv._tau, slv._sigma) == pytest.approx((jslv._tau, jslv._sigma),
                                                   rel=1e-5)
    np.testing.assert_allclose(slv.solution().numpy(), want, rtol=0,
                               atol=2e-4)
    slv, fit, ex = sparse_view_ct((32, 32), n_angles=12, method=method,
                                  device="cpu", stop_rate=iters)
    np.testing.assert_array_equal(ex["x_true"].numpy(), jex["x_true"])
    assert _rel(ex["y"].numpy(), jex["y"]) <= 1e-5
    # 32 power steps from other random starts
    assert ex["A"].lipschitz == pytest.approx(jex["A"].lipschitz, rel=1e-3)
    slv.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit)
    x = slv.solution().numpy()
    np.testing.assert_allclose(x, want, rtol=0, atol=2e-4)
    assert x.min() >= 0
    assert float(slv.objective_func(slv._mstate)) < float(
        slv.objective_func({"x": fit["x0"]}))
