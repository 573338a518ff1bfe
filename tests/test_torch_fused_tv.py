"""The port's fused TV step (pyxu_tpu_torch.ops.fused_tv) against pyxu_tpu.

The plain PyTorch versions are held against ``tv_step_xla`` and against the
Pallas kernels in interpret mode, with the shapes and tolerances of
``tests/test_fused_tv.py``.  The CUDA kernels are held against the plain
versions in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import ASYM, _bf16_ulp, _gauss

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.ops.fused_tv import (_normal_op_data, tv_step_pallas,
                                   tv_step_xla, tv_stepk_pallas)
from pyxu_tpu_torch.ops import fused_tv as ft
from pyxu_tpu_torch.ops.stencil import adj_axis, fwd_axis
from pyxu_tpu_torch.opt.solver import CondatVu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(H, W, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((H, W)).astype(dtype)
    z = (rng.standard_normal((2, H, W)) * 0.1).astype(dtype)
    b = (rng.standard_normal((H, W)) * 0.1).astype(dtype)
    return x, z, b


def _params(k0, k1, c0, c1, mode, rho, cst=1.0, lam=0.01, tau=0.2,
            sigma=0.15):
    return ft.TVParams(k0=tuple(map(float, k0)), k1=tuple(map(float, k1)),
                       c0=c0, c1=c1, cst=cst, lam=lam, tau=tau, sigma=sigma,
                       rho=rho, mode_k=mode, mode_d=mode)


# one compile a parameter set and shape (the eager step compiles op by op)
_tv_step_xla = jax.jit(tv_step_xla, static_argnames=(
    "c0", "c1", "cst", "lam", "tau", "sigma", "rho", "mode_k", "mode_d"))


def _xla(x, z0, z1, b, p):
    return _tv_step_xla(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(z1),
                        jnp.asarray(b), jnp.asarray(np.float32(p.k0)),
                        jnp.asarray(np.float32(p.k1)), c0=p.c0, c1=p.c1,
                        cst=p.cst, lam=p.lam, tau=p.tau, sigma=p.sigma,
                        rho=p.rho, mode_k=p.mode_k, mode_d=p.mode_d)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("rho", [1.0, 0.9])
@pytest.mark.parametrize("taps", ["gauss", "asym"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ref_matches_tv_step_xla(mode, rho, taps, dtype):
    k0, k1, c0, c1 = (_gauss(), _gauss(), 4, 4) if taps == "gauss" else ASYM
    p = _params(k0, k1, c0, c1, mode, rho, cst=0.7, lam=0.02, tau=0.11,
                sigma=0.21)
    x, z, b = _state(64, 41, dtype)
    want = _xla(x, z[0], z[1], b, p)
    got = ft.tv_step_ref(_t(x), _t(z[0]), _t(z[1]), _t(b), p.k0, p.k1, c0, c1,
                         cst=p.cst, lam=p.lam, tau=p.tau, sigma=p.sigma,
                         rho=rho, mode_k=mode, mode_d=mode)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for w, g in zip(want, got):
        assert g.dtype == _t(x).dtype
        assert _err(w, g) < tol


def _taps(taps):
    return (_gauss(), _gauss(), 4, 4) if taps == "gauss" else ASYM


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("taps", ["gauss", "asym"])
def test_normal_taps_match_normal_op_data(taps, mode):
    """The kernel's normal-form taps are the JAX package's ``kernel_g``
    bands (the float32 rounding of the same float64 values)."""
    k0, k1, c0, c1 = _taps(taps)
    k0, k1 = tuple(map(float, k0)), tuple(map(float, k1))
    data = _normal_op_data(40, 48, k0, k1, c0, c1, mode)
    for got, want in ((ft.normal_taps(k0), data[0]),
                      (ft.normal_taps(k1), data[5])):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _err(got, want) < 1e-7


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("taps", ["gauss", "asym"])
def test_normal_band_is_ktk_inside_the_window(taps, mode):
    """Away from the edges (L-1 along each axis) the two banded passes equal
    adj(fwd(x)), whatever the centres (ASYM: c1 = 2 of 4 taps) and the
    boundary mode."""
    k0, k1, c0, c1 = _taps(taps)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((40, 48)))
    k0, k1 = np.float64(k0), np.float64(k1)
    want = adj_axis(adj_axis(fwd_axis(fwd_axis(x, k0, c0, 0, mode),
                                      k1, c1, 1, mode), k1, c1, 1, mode),
                    k0, c0, 0, mode)
    m0, m1 = len(k0) - 1, len(k1) - 1
    got = ft.normal_band(x, ft.normal_taps(k0, np.float64),
                         ft.normal_taps(k1, np.float64))
    assert got.shape == (40 - 2 * m0, 48 - 2 * m1)
    assert _err(got, want[m0:40 - m0, m1:48 - m1]) < 1e-12


def test_plain_step_matches_pallas_interpret():
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 0.9)
    x, z, b = _state(64, 41)
    xg, zg = tv_step_pallas(jnp.asarray(x), jnp.asarray(z), jnp.asarray(b),
                            k0=p.k0, k1=p.k1, c0=4, c1=4, band=16,
                            interpret=True, cst=p.cst, lam=p.lam, tau=p.tau,
                            sigma=p.sigma, rho=p.rho)
    xt, zt = ft.tv_step_plain(_t(x), _t(z), _t(b), p)
    assert _err(xg, xt) < 1e-5 and _err(zg, zt) < 1e-5


@pytest.mark.parametrize("mode", ["symmetric", "constant"])
def test_plain_stepk_matches_chained_xla(mode):
    p = _params(_gauss(), _gauss(), 4, 4, mode, 0.9)
    x, z, b = _state(192, 41)
    s = (x, z[0], z[1])
    for _ in range(3):
        s = _xla(s[0], s[1], s[2], b, p)
    xt, zt = ft.tv_stepk_plain(_t(x), _t(z), _t(b), p, 3)
    assert _err(s[0], xt) < 3e-5
    assert _err(s[1], zt[0]) < 3e-5 and _err(s[2], zt[1]) < 3e-5


def test_plain_stepk_matches_pallas_interpret():
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 0.9)
    x, z, b = _state(192, 41)
    xg, zg = tv_stepk_pallas(jnp.asarray(x), jnp.asarray(z), jnp.asarray(b),
                             k0=p.k0, k1=p.k1, c0=4, c1=4, band=48,
                             interpret=True, n_steps=3, cst=p.cst, lam=p.lam,
                             tau=p.tau, sigma=p.sigma, rho=p.rho)
    xt, zt = ft.tv_stepk(_t(x), _t(z), _t(b), p, 3)     # CPU -> plain
    assert _err(xg, xt) < 3e-5 and _err(zg, zt) < 3e-5


@pytest.mark.parametrize("n_steps", [1, 3])
def test_bf16_dual_storage(n_steps):
    """z stored bf16, arithmetic f32, state rounded after every iteration —
    the JAX package's storage contract (its ``xla`` fused step)."""
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 1.0)
    x, z, b = _state(96, 41)
    zb = jnp.asarray(z).astype(jnp.bfloat16)
    xj, zj = jnp.asarray(x), zb
    for _ in range(n_steps):
        xn, z0n, z1n = _xla(xj, zj[0].astype(jnp.float32),
                            zj[1].astype(jnp.float32), b, p)
        xj, zj = xn, jnp.stack([z0n, z1n]).astype(jnp.bfloat16)
    zt_in = _t(z).to(torch.bfloat16)
    xt, zt = ft.tv_stepk_plain(_t(x), zt_in, _t(b), p, n_steps)
    assert zt.dtype == torch.bfloat16 and xt.dtype == torch.float32
    zj32 = np.asarray(zj.astype(jnp.float32))
    dz = np.abs(zt.float().numpy() - zj32)
    assert np.all(dz <= _bf16_ulp(zj32) + 1e-6)
    assert _err(xj, xt) < 1e-5 + 4 * p.tau * (n_steps - 1) * \
        float(_bf16_ulp(np.abs(zj32).max()))


def _jax_problem(H, W, mode="symmetric", lam=0.01, seed=3):
    y = np.random.default_rng(seed).random((H, W), np.float32)
    k = _gauss()
    K = jlin.Stencil((H, W), [jnp.asarray(k)] * 2, [4, 4], mode=mode)
    return (0.5 * jfunc.SquaredL2Norm((H, W)).asloss(jnp.asarray(y)) * K,
            jlin.Gradient((H, W), mode=mode),
            lam * jfunc.L21Norm((2, H, W), l2_axis=0), y)


def _torch_problem(H, W, mode="symmetric", lam=0.01, seed=3, kmode=None):
    y = np.random.default_rng(seed).random((H, W), np.float32)
    k = _gauss()
    K = tlin.Stencil((H, W), [k, k], [4, 4], mode=kmode or mode)
    f = 0.5 * tfunc.SquaredL2Norm((H, W)).asloss(torch.from_numpy(y)) * K
    return (f, tlin.Gradient((H, W), mode=mode),
            lam * tfunc.L21Norm((2, H, W), l2_axis=0), y)


def _match(f, g, h, D, shape=None):
    x = torch.zeros(shape or f.dim_shape)
    z = torch.zeros((2,) + tuple(x.shape))
    return ft.match_fused_tv(f, g, h, D, tau=0.1, sigma=0.1, rho=1.0, x=x, z=z)


def test_matcher_accepts_tv_and_b_matches():
    f, D, h, _ = _torch_problem(96, 100)
    m = _match(f, None, h, D)
    assert m is not None and m.params.halo == (4, 4)
    assert (m.params.cst, m.params.lam) == (1.0, pytest.approx(0.01))
    fj, _, _, _ = _jax_problem(96, 100)
    _, cj, _ = fj._quad_spec()
    bj = cj.grad(jnp.zeros((96, 100), jnp.float32))
    assert _err(bj, m.b) < 1e-6


def test_matcher_rejects_non_tv_problems():
    H, W = 96, 100
    f, D, h, _ = _torch_problem(H, W)
    assert _match(f, None, 0.1 * tfunc.L1Norm((2, H, W)), D) is None
    assert _match(tfunc.L1Norm((H, W)), None, h, D) is None
    assert _match(f, tfunc.L1Norm((H, W)), h, D) is None       # g present
    fw, _, _, _ = _torch_problem(H, W, kmode="wrap")
    assert _match(fw, None, h, D) is None
    f2, D2, h2, _ = _torch_problem(24, 64)     # image below one window
    assert _match(f2, None, h2, D2) is None
    fm, Dm, hm, _ = _torch_problem(H, W, mode="constant", kmode="symmetric")
    assert _match(fm, None, hm, Dm) is not None   # K and D modes may differ


@pytest.mark.parametrize("shape,want", [((100, 120), 3), ((90, 100), 2),
                                        ((60, 96), None)])
def test_fused2_steps_down_when_windows_exceed_image(shape, want):
    f, D, h, _ = _torch_problem(*shape)
    m = _match(f, None, h, D)
    assert m is not None
    assert ft.match_fused_tv2(m, shape, 3) == want
    assert ft.match_fused_tv2(m, shape) is None     # N_STEPS = 1


def test_fusion_off_switch_and_recorded_path(monkeypatch):
    f, D, h, y = _torch_problem(100, 120)
    slv = CondatVu(f=f, h=h, K=D)
    slv.m_init(x0=torch.from_numpy(y))
    assert slv.fused_path == "plain" and slv._m_step2_iters == 0  # K = 1
    monkeypatch.setattr(ft, "N_STEPS", 3)       # the K-step hook
    for fuse, path in ((True, "plain"), (False, None)):
        slv = CondatVu(f=f, h=h, K=D, fuse=fuse)
        slv.m_init(x0=torch.from_numpy(y))
        assert slv.fused_path == path
        assert (slv._m_step2_iters == 3) == fuse
