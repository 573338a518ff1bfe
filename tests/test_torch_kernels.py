"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (the other ``test_torch_*`` files take their
shared inputs from here).  On a machine with an NVIDIA GPU (``nvcc`` on the
path or under ``/usr/local/cuda``)::

    python -m pytest tests/test_torch_kernels.py --noconftest -q -m cuda

Without a GPU the ``cuda`` tests skip with a reason; the wrapper checks run
anywhere.
"""

import numpy as np
import pytest
import scipy.ndimage as snd
import torch

from pyxu_tpu_torch.ops import fused_tv as ft
from pyxu_tpu_torch.ops import stencil as st


def _gauss(n=9, sig=2.0):
    k = np.exp(-0.5 * ((np.arange(n) - (n - 1) / 2) / sig) ** 2)
    return (k / k.sum()).astype(np.float32)


ASYM = (np.array([0.2, 0.5, 0.3], np.float32),
        np.array([0.1, 0.6, 0.2, 0.1], np.float32), 1, 2)


def _state(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((H, W), np.float32)),
            torch.from_numpy((rng.standard_normal((2, H, W)) * 0.1)
                             .astype(np.float32)),
            torch.from_numpy((rng.standard_normal((H, W)) * 0.1)
                             .astype(np.float32)))


def _params(k0, k1, c0, c1, mode, rho):
    return ft.TVParams(k0=tuple(map(float, k0)), k1=tuple(map(float, k1)),
                       c0=c0, c1=c1, cst=0.7, lam=0.02, tau=0.11, sigma=0.21,
                       rho=rho, mode_k=mode, mode_d=mode)


def _bf16_ulp(v):
    _, e = np.frexp(np.abs(np.asarray(v, np.float32)))
    return np.ldexp(1.0, e - 8)


def test_wrappers_raise_off_cpu_without_kernel():
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 1.0)
    x = torch.zeros((64, 64), device="meta")
    z = torch.zeros((2, 64, 64), device="meta")
    n0, nk = ft.tv_step.launches, ft.tv_stepk.launches
    with pytest.raises(ValueError):
        ft.tv_step(x, z, x, p)
    with pytest.raises(ValueError):
        ft.tv_stepk(x, z, x, p, 3)
    assert (ft.tv_step.launches, ft.tv_stepk.launches) == (n0, nk)


def test_cpu_wrappers_run_the_plain_version():
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 0.9)
    x, z, b = _state(64, 41)
    n0, nk = ft.tv_step.launches, ft.tv_stepk.launches
    xs, zs = ft.tv_step(x, z, b, p)
    xp, zp = ft.tv_step_plain(x, z, b, p)
    assert torch.equal(xs, xp) and torch.equal(zs, zp)
    xs, zs = ft.tv_stepk(x, z, b, p, 2)
    xp, zp = ft.tv_step_plain(*ft.tv_step_plain(x, z, b, p), b, p)
    assert torch.equal(xs, xp) and torch.equal(zs, zp)
    assert (ft.tv_step.launches, ft.tv_stepk.launches) == (n0, nk)
    with pytest.raises(ValueError):
        ft.tv_stepk(x, z, b, p, 1)


def test_window_and_shared_memory_rule():
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 1.0)
    assert p.halo == (4, 4)
    assert p.apron == (8, 8)
    # the K-step's 48x64 tile plus K levels of 2h-px aprons per side, and
    # one row and column; the single step's 32x32 tile plus one level
    assert ft.smem_bytes(p, 3) == 5 * 97 * 113 * 4
    assert ft.smem_bytes(p, 1) == 5 * 49 * 49 * 4
    assert ft.window_fits((97, 113), p, 3)
    assert not ft.window_fits((96, 113), p, 3)
    assert not ft.window_fits((97, 112), p, 3)
    assert not ft.window_fits((4000, 4000), p, 5)      # shared memory


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["gauss", "asym"])
@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("rho", [1.0, 0.9])
@pytest.mark.parametrize("zdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_steps", [1, 2, 3])
def test_kernel_matches_plain(cuda, taps, mode, rho, zdt, n_steps):
    k0, k1, c0, c1 = (_gauss(), _gauss(), 4, 4) if taps == "gauss" else ASYM
    p = _params(k0, k1, c0, c1, mode, rho)
    x, z, b = (a.to(cuda) for a in _state(200, 180))
    z = z.to(getattr(torch, zdt))
    if n_steps == 1:
        (xk, zk), (xp, zp) = ft.tv_step(x, z, b, p), ft.tv_step_plain(x, z, b, p)
    else:
        xk, zk = ft.tv_stepk(x, z, b, p, n_steps)
        xp, zp = ft.tv_stepk_plain(x, z, b, p, n_steps)
    torch.cuda.synchronize()
    assert xk.dtype == xp.dtype and zk.dtype == zp.dtype
    dx = float((xk - xp).abs().max())
    dz = (zk.float() - zp.float()).abs().cpu().numpy()
    zp32 = zp.float().cpu().numpy()
    if zdt == "float32":
        assert dx < 1e-5 and dz.max() < 1e-5
    else:
        # one bf16 ulp of the stored z, plus what the earlier levels' ulp
        # flips carry in (x through D^T z: 4 neighbours, times tau)
        zmax_ulp = float(_bf16_ulp(np.abs(zp32).max()))
        assert np.all(dz <= _bf16_ulp(zp32) + 1e-5 + (n_steps - 1) * zmax_ulp)
        assert dx < 1e-5 + 4 * p.tau * (n_steps - 1) * zmax_ulp


@pytest.mark.cuda
def test_kernel_counts_launches(cuda):
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 1.0)
    x, z, b = (a.to(cuda) for a in _state(96, 96))
    n0, nk = ft.tv_step.launches, ft.tv_stepk.launches
    ft.tv_step(x, z, b, p)
    ft.tv_stepk(x, z, b, p, 3)
    assert (ft.tv_step.launches, ft.tv_stepk.launches) == (n0 + 1, nk + 1)
    with pytest.raises(ValueError):
        ft.tv_step(x.double(), z.double(), b.double(), p)   # no f64 kernel


# ------------------------------------------------------- separable stencil --

# shapes and tap counts of tests/test_pallas_ops.py, an image narrower than
# a tile whose pad width equals its length, and off-centre centres
ST_SHAPES = [(50, 70), (64, 128), (33, 257), (4, 9)]
ST_TAPS = {"3x4": (3, 4, 1, 2), "9x9": (9, 9, 4, 4), "1x5": (1, 5, 0, 1),
           "4x3off": (4, 3, 3, 0)}


def _sep(taps, mode, seed=1):
    lh, lw, ch, cw = ST_TAPS[taps]
    rng = np.random.default_rng(seed)
    return st.SepTaps(k0=tuple(rng.standard_normal(lh)), c0=ch,
                      k1=tuple(rng.standard_normal(lw)), c1=cw, mode=mode)


def _fits(shape, p):
    return p.halo[0] <= shape[0] and p.halo[1] <= shape[1]


def _scipy_apply(x, p):
    """Reference apply: scipy's correlate1d per axis (numpy 'symmetric' is
    scipy's 'reflect')."""
    mode = "reflect" if p.mode == "symmetric" else "constant"
    out = x
    for ax, k, c in ((0, p.k0, p.c0), (1, p.k1, p.c1)):
        out = snd.correlate1d(out, np.asarray(k), axis=ax, mode=mode,
                              origin=c - len(k) // 2)
    return out


@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", sorted(ST_TAPS))
def test_stencil_plain_matches_scipy_and_dot_test(taps, mode):
    rng = np.random.default_rng(3)
    for shape in ST_SHAPES:
        p = _sep(taps, mode)
        if not _fits(shape, p):
            continue
        x = rng.standard_normal(shape)
        y = rng.standard_normal(shape)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        got = st.separable_correlate2d_plain(xt, p).numpy()
        np.testing.assert_allclose(got, _scipy_apply(x, p), rtol=0,
                                   atol=1e-12)
        adj = st.separable_correlate2d_plain(yt, p, adjoint=True).numpy()
        assert abs(np.sum(got * y) - np.sum(x * adj)) < 1e-10 * x.size


def test_stencil_cpu_wrapper_runs_the_plain_version():
    p = _sep("9x9", "symmetric")
    x = torch.from_numpy(np.random.default_rng(0).random((3, 40, 30),
                                                         np.float32))
    n0 = st.separable_correlate2d.launches
    for adj in (False, True):
        assert torch.equal(st.separable_correlate2d(x, p, adj),
                           st.separable_correlate2d_plain(x, p, adj))
    assert st.separable_correlate2d.launches == n0


def test_stencil_wrapper_raises_off_cpu_without_kernel():
    p = _sep("3x4", "constant")
    n0 = st.separable_correlate2d.launches
    with pytest.raises(ValueError):
        st.separable_correlate2d(torch.zeros((16, 16), device="meta"), p)
    assert st.separable_correlate2d.launches == n0


def test_stencil_kernel_rule():
    assert st.kernel_takes(_sep("9x9", "symmetric"))
    assert not st.kernel_takes(st.SepTaps((1.0,) * 33, 0, (1.0,), 0))
    assert not st.kernel_takes(st.SepTaps((1.0,), 0, (1.0,), 0, "wrap"))
    assert _sep("4x3off", "constant").halo == (3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", sorted(ST_TAPS))
@pytest.mark.parametrize("shape", ST_SHAPES, ids=str)
def test_stencil_kernel_matches_plain(cuda, shape, taps, mode, adjoint,
                                      dtype):
    p = _sep(taps, mode)
    assert _fits(shape, p)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape)).to(
        getattr(torch, dtype)).to(cuda)
    n0 = st.separable_correlate2d.launches
    got = st.separable_correlate2d(x, p, adjoint)
    want = st.separable_correlate2d_plain(x, p, adjoint)
    torch.cuda.synchronize()
    assert st.separable_correlate2d.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    # sums of up to (4+1) x (4+1) products per output in another order
    tol = (1e-5 if dtype == "float32" else 1e-12) * float(x.abs().max()) \
        * max(1.0, float(np.sum(np.abs(p.k0)) * np.sum(np.abs(p.k1))))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ST_SHAPES, ids=str)
def test_stencil_kernel_reads_stay_in_the_image(cuda, shape):
    """A build that counts window reads outside the image plane (and loads
    zero there instead) counts none, in a batch whose images sit back to
    back, and agrees with the plain version."""
    lib = st._library(("ST_COUNT_STRAY_READS",))[0]
    assert lib.stencil_stray_reads() == 0
    x = torch.randn((3,) + shape, device=cuda, dtype=torch.float64)
    for taps in sorted(ST_TAPS):
        for mode in ("constant", "symmetric"):
            p = _sep(taps, mode)
            for adjoint in (False, True):
                got = st._launch(lib, x, p, adjoint)
                want = st.separable_correlate2d_plain(x, p, adjoint)
                torch.cuda.synchronize()
                assert lib.stencil_stray_reads() == 0, (taps, mode, adjoint)
                assert float((got - want).abs().max()) <= 1e-12 * float(
                    x.abs().max()) * float(np.sum(np.abs(p.k0))
                                           * np.sum(np.abs(p.k1)))


@pytest.mark.cuda
def test_stencil_kernel_batch_and_errors(cuda):
    p = _sep("9x9", "symmetric")
    x = torch.randn((2, 3, 70, 90), device=cuda)
    got = st.separable_correlate2d(x, p, adjoint=True)
    want = st.separable_correlate2d_plain(x, p, adjoint=True)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(x.abs().max()) \
        * float(np.sum(np.abs(p.k0)) * np.sum(np.abs(p.k1)))
    with pytest.raises(ValueError):
        st.separable_correlate2d(x.half(), p)            # no f16 kernel
    with pytest.raises(ValueError):
        st.separable_correlate2d(x[..., ::2], p)         # not contiguous


# ------------------------------------------------------------- 2-D NUFFT --

from pyxu_tpu_torch.ops import nufft as nu  # noqa: E402

NU_SETS = ["uniform", "gauss", "cluster", "edges", "onebin"]


def _nu_points(kind, M, seed=0):
    """(M, 2) points in [-pi, pi]: the three point sets of the RI path
    (uniform, the workload's Gaussian uv, a clustered set), points at 0
    and just below 2 pi, and a set inside one 32x32 bin (split into
    subproblems)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-np.pi, np.pi, (M, 2))
    if kind == "gauss":
        return rng.normal(0, np.pi / 3, (M, 2)).clip(-np.pi, np.pi)
    if kind == "cluster":
        return np.clip(rng.normal(0.3, 0.35, (M, 2)), -np.pi, np.pi)
    if kind == "edges":
        vals = np.array([0.0, -0.0, np.nextafter(2 * np.pi, 0), -1e-300,
                         np.pi, -np.pi, np.nextafter(np.pi, 0), 1e-300])
        return rng.choice(vals, (M, 2))
    if kind == "onebin":
        return 0.5 + 0.01 * rng.random((M, 2))
    raise ValueError(kind)


def _nu_plan(kind, M, nf, w, dtype, device="cpu", seed=0):
    x = torch.remainder(torch.from_numpy(_nu_points(kind, M, seed)),
                        2 * np.pi).to(device)
    return nu.plan2(x, nf, w, 2.3 * w, dtype)


def test_nufft_plan_covers_every_point_once():
    for kind in NU_SETS:
        p = _nu_plan(kind, 3000, (50, 45), 7, torch.float64)
        assert sorted(p.perm.tolist()) == list(range(3000))
        sub = p.sub.long()
        assert int(sub[:, 2].sum()) == 3000
        assert int(sub[:, 2].max()) <= nu.MAX_SUB and int(sub[:, 2].min()) > 0
        # subproblems tile the sorted points in order, each inside one bin
        assert sub[0, 1] == 0 and torch.equal(sub[1:, 1],
                                              sub[:-1, 1] + sub[:-1, 2])
        base = p.i0.long() + p.w // 2
        assert int(base.min()) >= 0 and all(
            int(base[a].max()) < p.nf[a] for a in range(2))
        bins = (base[0] // nu.BIN) * p.nbins[1] + base[1] // nu.BIN
        owner = torch.repeat_interleave(sub[:, 0], sub[:, 2])
        assert torch.equal(bins, owner)
        assert float(p.off.min()) > p.w / 2 - 1
        assert float(p.off.max()) <= p.w / 2
    p = _nu_plan("onebin", 3000, (50, 45), 7, torch.float64)
    assert p.sub.shape[0] == 3


@pytest.mark.parametrize("kind", NU_SETS)
def test_nufft_plain_spread_interp_are_adjoint(kind):
    p = _nu_plan(kind, 700, (40, 36), 7, torch.float64)
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.standard_normal((2, 700, 2)))
    g = torch.from_numpy(rng.standard_normal((2, 40, 36, 2)))
    lhs = float(torch.sum(nu.nufft_spread2_plain(c, p) * g))
    rhs = float(torch.sum(c * nu.nufft_interp2_plain(g, p)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_nufft_plain_matches_a_loop():
    """The plain spread against a point-by-point loop in numpy."""
    p = _nu_plan("edges", 40, (20, 24), 5, torch.float64)
    rng = np.random.default_rng(2)
    c = rng.standard_normal((1, 40, 2))
    got = nu.nufft_spread2_plain(torch.from_numpy(c), p).numpy()[0]
    want = np.zeros((20, 24, 2))
    perm, i0, off = p.perm.numpy(), p.i0.numpy(), p.off.numpy()
    for j in range(40):
        w1 = nu.es_weights(torch.tensor(off[0, j]), 5, p.beta).numpy()
        w2 = nu.es_weights(torch.tensor(off[1, j]), 5, p.beta).numpy()
        for a in range(5):
            for b in range(5):
                want[(i0[0, j] + a) % 20, (i0[1, j] + b) % 24] += \
                    c[0, perm[j]] * w1[a] * w2[b]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_nufft_wrappers_cpu_plain_and_meta_raise():
    p = _nu_plan("uniform", 300, (40, 36), 7, torch.float32)
    c = torch.randn((1, 300, 2))
    g = torch.randn((1, 40, 36, 2))
    n0 = (nu.nufft_spread2.launches, nu.nufft_interp2.launches)
    assert torch.equal(nu.nufft_spread2(c, p), nu.nufft_spread2_plain(c, p))
    assert torch.equal(nu.nufft_interp2(g, p), nu.nufft_interp2_plain(g, p))
    with pytest.raises(ValueError):
        nu.nufft_spread2(c.to("meta"), p)
    with pytest.raises(ValueError):
        nu.nufft_interp2(g.to("meta"), p)
    assert (nu.nufft_spread2.launches, nu.nufft_interp2.launches) == n0
    with pytest.raises(ValueError):
        nu.plan2(torch.zeros((3, 2), dtype=torch.float64), (40, 36), 17, 1.0,
                 torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("w", [2, 7, 16])
@pytest.mark.parametrize("nf", [(64, 80), (50, 45), (20, 33)], ids=str)
@pytest.mark.parametrize("kind", NU_SETS)
def test_nufft_kernels_match_plain(cuda, kind, nf, w, dtype):
    """Spread and interp on the card against their plain versions, over
    the point sets, grid sides that are not multiples of the bin (and one
    smaller than a subgrid), 2-16 taps, both dtypes and a batch of 2."""
    dt = getattr(torch, dtype)
    p = _nu_plan(kind, 2500, nf, w, dt, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    c = torch.randn((2, 2500, 2), generator=gen, device=cuda, dtype=dt)
    g = torch.randn((2,) + nf + (2,), generator=gen, device=cuda, dtype=dt)
    n0 = (nu.nufft_spread2.launches, nu.nufft_interp2.launches)
    gk, gp = nu.nufft_spread2(c, p), nu.nufft_spread2_plain(c, p)
    vk, vp = nu.nufft_interp2(g, p), nu.nufft_interp2_plain(g, p)
    torch.cuda.synchronize()
    assert (nu.nufft_spread2.launches, nu.nufft_interp2.launches) == (
        n0[0] + 1, n0[1] + 1)
    # float atomics (spread) and the taps' summation order differ from the
    # plain version's, run to run
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * float(gp.abs().max())
    assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("M", [0, 1, 3])
def test_nufft_kernels_few_points(cuda, M, dtype):
    dt = getattr(torch, dtype)
    p = _nu_plan("edges", M, (64, 80), 7, dt, cuda)
    c = torch.randn((1, M, 2), device=cuda, dtype=dt)
    g = torch.randn((1, 64, 80, 2), device=cuda, dtype=dt)
    gk, vk = nu.nufft_spread2(c, p), nu.nufft_interp2(g, p)
    gp, vp = nu.nufft_spread2_plain(c, p), nu.nufft_interp2_plain(g, p)
    torch.cuda.synchronize()
    assert gk.shape == (1, 64, 80, 2) and vk.shape == (1, M, 2)
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * max(float(gp.abs().max()), 1)
    if M == 0:
        assert not gk.any()
    else:
        assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("upsampfac", [2.0, 1.25])
@pytest.mark.parametrize("real", [False, True])
def test_nufft_operator_on_the_card(cuda, upsampfac, real):
    """NUFFT type 2 and its gram on the card against the same operator on
    the CPU (plain versions), float64.  cuFFT and the CPU's FFT round in
    another order, and at upsampfac 1.25 the deconvolution amplifies that
    by up to max 1/phihat: 1e-9 of the largest value."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    x = _nu_points("gauss", 4000)
    ops = {dev: NUFFT.type2(x, (48, 40), eps=1e-8, real=real,
                            upsampfac=upsampfac, dtype=torch.float64,
                            device=dev) for dev in ("cpu", cuda)}
    assert ops[cuda].kernel_path == "kernel"
    f = torch.randn((3,) + ops["cpu"].dim_shape, dtype=torch.float64)
    y = torch.randn((3, 4000, 2), dtype=torch.float64)
    for name in ("apply", "adjoint"):
        a = f if name == "apply" else y
        want = getattr(ops["cpu"], name)(a)
        got = getattr(ops[cuda], name)(a.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-9 * float(
            want.abs().max())
    want = ops["cpu"].gram().apply(f)
    got = ops[cuda].gram().apply(f.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())
