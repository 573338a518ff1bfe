"""The rest of the port's NUFFT against pyxu_tpu, on the CPU: type 3
(monolithic and chunked) at d = 1, 2 and 3, types 1 and 2 at d = 1, the
plan diagnostics, and the Toeplitz gram's Chan circulant
(``_chan_lam``, ``_circulant_precond``).

The same numpy points and values go through the JAX package (under
``jax.jit``; it runs type 3 through its scatter path off the TPU, and
under x64 here, ``tests/conftest.py``) and the port, whose spread and
interp run their plain versions on CPU tensors.  Tolerances, relative l2:
1e-4 at float32 and 1e-10 at float64 against the JAX package; 1e-4
(float32, eps 1e-6) and 1e-6 (float64, eps 1e-7) against the direct sums
(``nudft1``/``nudft2``/``nudft3``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.operator.linop.nufft as jnu
import pyxu_tpu_torch.operator.linop.nufft as tnu

F32, F64 = np.float32, np.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tdt(fdtype):
    return torch.float32 if np.dtype(fdtype) == F32 else torch.float64


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _cplx(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1]


def _tol_jax(fdtype):
    return 1e-4 if np.dtype(fdtype) == F32 else 1e-10


def _tol_direct(fdtype):
    return 1e-4 if np.dtype(fdtype) == F32 else 1e-6


def _eps(fdtype):
    return 1e-6 if np.dtype(fdtype) == F32 else 1e-7


def _clouds(d, M, K, seed):
    """Points off the origin and frequencies of a few dozen cells' extent:
    fine grids of 36-48 cells an axis."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 2.5, (M, d))
    z = rng.uniform(-9.0, 6.0, (K, d))
    return x, z, rng


def _both(fn_j, fn_t, a, fdtype):
    """One numpy input through the JAX operator's method (jitted) and the
    port's."""
    got = fn_t(torch.from_numpy(np.asarray(a, fdtype))).numpy()
    want = np.asarray(jax.jit(fn_j)(jnp.asarray(np.asarray(a, fdtype))))
    return got, want


# ---------------------------------------------------------------- type 3 --

# d, dtype, isign, real: within each d, each value of every option once
PLANS3 = [(1, F32, 1, False), (1, F64, -1, True), (2, F32, -1, True),
          (2, F64, 1, False), (3, F32, 1, True), (3, F64, -1, False),
          (3, F32, -1, False), (3, F64, 1, True)]


@pytest.mark.parametrize("d,fdtype,isign,real", PLANS3)
def test_type3_matches_jax_and_the_direct_sum(d, fdtype, isign, real):
    M, K = (160, 140) if d < 3 else (90, 80)
    x, z, rng = _clouds(d, M, K, seed=d + 10 * (isign > 0))
    eps = _eps(fdtype)
    J = jnu.NUFFT.type3(x, z, isign=isign, eps=eps, real=real)
    T = tnu.NUFFT.type3(x, z, isign=isign, eps=eps, real=real,
                        dtype=_tdt(fdtype), device="cpu")
    assert T._nf == J._nf and T.kernel_path == ("plain" if d == 1
                                                 else "kernel")
    assert T.dim_shape == J.dim_shape and T.codim_shape == J.codim_shape
    np.testing.assert_allclose(T._gamma, J._gamma, rtol=1e-15)
    assert T.lipschitz == pytest.approx(J.lipschitz, rel=1e-12)
    c = rng.standard_normal(T.dim_shape)
    f = rng.standard_normal(T.codim_shape)
    got, want = _both(J.apply, T.apply, c, fdtype)
    assert got.dtype == fdtype and got.shape == (K, 2)
    assert _rel(got, want) <= _tol_jax(fdtype)
    cc = c if real else _cplx(c)
    assert _rel(_cplx(got), jnu.nudft3(cc, x, z, isign)) <= _tol_direct(fdtype)
    got, want = _both(J.adjoint, T.adjoint, f, fdtype)
    assert got.shape == T.dim_shape and _rel(got, want) <= _tol_jax(fdtype)
    back = np.exp(-1j * isign * (x @ z.T)) @ _cplx(f)
    assert _rel(got if real else _cplx(got),
                back.real if real else back) <= _tol_direct(fdtype)


def test_type3_batch_nf_override_and_refusals():
    x, z, rng = _clouds(2, 60, 50, seed=4)
    T = tnu.NUFFT.type3(x, z, dtype=torch.float64, device="cpu")
    c = torch.from_numpy(rng.standard_normal((3, 2, 60, 2)))
    out = T.apply(c)
    assert out.shape == (3, 2, 50, 2)
    np.testing.assert_allclose(out[1, 0].numpy(), T.apply(c[1, 0]).numpy(),
                               rtol=0, atol=1e-12)
    # a larger fine grid gives the same transform
    big = tuple(n + 12 for n in T._nf)
    Tb = tnu._NUFFT3(x, z, nf=big, dtype=torch.float64, device="cpu")
    Jb = jnu._NUFFT3(x, z, nf=big)
    assert Tb._nf == Jb._nf == big
    assert _rel(Tb.apply(c[0, 0]).numpy(), out[0, 0].numpy()) <= 1e-6
    with pytest.raises(ValueError, match="at least"):
        tnu._NUFFT3(x, z, nf=(36, 36), device="cpu")
    with pytest.raises(ValueError, match="d = "):
        tnu.NUFFT.type3(x, z[:, :1], device="cpu")
    with pytest.raises(ValueError, match="complex input only"):
        tnu.NUFFT.type3(x, z, real=True, chunked=True, device="cpu")


# --------------------------------------------------------- chunked type 3 --

def test_chunked_partition_matches_jax():
    """At float64 (16 bytes a cell, the JAX package's under x64) the
    partition, stats(), params() and auto_chunk()'s lists are the JAX
    package's; apply and adjoint match it; allocate refuses a
    non-partition as it does."""
    M, K = 300, 200
    rng = np.random.default_rng(113)
    x = rng.uniform(-3, 3, (M, 2))
    z = rng.uniform(-25, 25, (K, 2))
    J = jnu.NUFFT.type3(x, z, eps=1e-7, chunked=True, fft_mem_mb=0.02)
    T = tnu.NUFFT.type3(x, z, eps=1e-7, chunked=True, fft_mem_mb=0.02,
                        dtype=torch.float64, device="cpu")
    assert T.stats() == J.stats() and T.stats()["n_x_blocks"] > 1
    assert T.params() == J.params() and T._x_parts == J._x_parts
    assert T._z_parts == J._z_parts and T.kernel_path == "kernel"
    c, f = rng.standard_normal((M, 2)), rng.standard_normal((K, 2))
    got, want = _both(J.apply, T.apply, c, F64)
    assert _rel(got, want) <= 1e-10
    assert _rel(_cplx(got), jnu.nudft3(_cplx(c), x, z)) <= 1e-6
    got, want = _both(J.adjoint, T.adjoint, f, F64)
    assert _rel(got, want) <= 1e-10
    for kw in (dict(max_mem=0.01), dict(max_mem=64.0, max_anisotropy=2.0)):
        (xj, zj), (xt, zt) = J.auto_chunk(**kw), T.auto_chunk(**kw)
        assert len(xj) == len(xt) and len(zj) == len(zt)
        assert all(np.array_equal(a, b) for a, b in zip(xj + zj, xt + zt))
    T.allocate(xt, zt)
    J.allocate(xj, zj)
    assert T.stats() == J.stats()
    got, want = _both(J.apply, T.apply, c, F64)
    assert _rel(got, want) <= 1e-10
    for op in (J, T):
        with pytest.raises(ValueError, match="partition"):
            op.allocate([np.arange(M - 1)], zt)


@pytest.mark.parametrize("d", [1, 3])
def test_chunked_float32_against_monolithic(d):
    M, K = 150, 120
    x, z, rng = _clouds(d, M, K, seed=20 + d)
    z = z * 3
    mono = tnu.NUFFT.type3(x, z, eps=1e-6, dtype=torch.float32, device="cpu")
    chnk = tnu.NUFFT.type3(x, z, eps=1e-6, chunked=True,
                           fft_mem_mb={1: 0.0005, 3: 0.3}[d],
                           dtype=torch.float32, device="cpu")
    st = chnk.stats()
    assert st["n_x_blocks"] * st["n_z_blocks"] > 1
    c = torch.from_numpy(rng.standard_normal((2, M, 2)).astype(F32))
    f = torch.from_numpy(rng.standard_normal((K, 2)).astype(F32))
    a = chnk.apply(c)
    assert a.shape == (2, K, 2) and a.dtype == torch.float32
    assert _rel(a.numpy(), mono.apply(c).numpy()) <= 1e-4
    assert _rel(_cplx(a[0].numpy()),
                jnu.nudft3(_cplx(c[0].numpy()), x, z)) <= 1e-4
    b = chnk.adjoint(f)
    assert _rel(b.numpy(), mono.adjoint(f).numpy()) <= 1e-4
    d1 = float((a[0].double() * f.double()).sum())
    d2 = float((c[0].double() * b.double()).sum())
    assert abs(d1 - d2) <= 1e-5 * max(abs(d1), 1.0)


# ------------------------------------------------------------ d = 1, 1/2 --

@pytest.mark.parametrize("kind,fdtype,isign,real", [
    ("type1", F32, 1, False), ("type1", F64, -1, True),
    ("type2", F64, 1, False), ("type2", F32, -1, True)])
def test_d1_types_1_2_match_jax(kind, fdtype, isign, real):
    rng = np.random.default_rng(7)
    x, N = rng.uniform(-np.pi, np.pi, 200), 24
    eps = _eps(fdtype)
    J = getattr(jnu.NUFFT, kind)(x, N, isign=isign, eps=eps, real=real)
    T = getattr(tnu.NUFFT, kind)(x, N, isign=isign, eps=eps, real=real,
                                 dtype=_tdt(fdtype), device="cpu")
    assert T.kernel_path == "plain" and T.params() == J.params()
    a = rng.standard_normal(T.dim_shape)
    b = rng.standard_normal(T.codim_shape)
    got, want = _both(J.apply, T.apply, a, fdtype)
    assert _rel(got, want) <= _tol_jax(fdtype)
    ac = a if real else _cplx(a)
    direct = (jnu.nudft1(ac, x, N, isign) if kind == "type1"
              else jnu.nudft2(ac, x, N, isign))
    assert _rel(_cplx(got), direct) <= _tol_direct(fdtype)
    got, want = _both(J.adjoint, T.adjoint, b, fdtype)
    assert _rel(got, want) <= _tol_jax(fdtype)
    if kind == "type2" and not real:
        G, GJ = T.gram(), J.gram()
        got, want = _both(GJ.apply, G.apply, a, fdtype)
        assert _rel(got, want) <= _tol_jax(fdtype)


# ------------------------------------------------------------ diagnostics --

def test_diagnostics_match_jax():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(0)
    x2 = rng.uniform(-np.pi, np.pi, (20, 2))
    x3, z3, _ = _clouds(2, 15, 11, seed=1)
    pairs = [(getattr(jnu.NUFFT, k)(x2, (5, 4), eps=1e-7),
              getattr(tnu.NUFFT, k)(x2, (5, 4), eps=1e-7,
                                    dtype=torch.float64, device="cpu"))
             for k in ("type1", "type2")]
    pairs.append((jnu.NUFFT.type3(x3, z3), tnu.NUFFT.type3(
        x3, z3, dtype=torch.float64, device="cpu")))
    for J, T in pairs:
        pj, pt = J.params(), T.params()
        assert pj._replace(dilation_factor=None) == pt._replace(
            dilation_factor=None)
        if pj.dilation_factor is not None:
            np.testing.assert_allclose(pt.dilation_factor,
                                       pj.dilation_factor, rtol=1e-15)
        # the JAX package's dense matrices come from float32 points
        np.testing.assert_allclose(T.ascomplexarray(), J.ascomplexarray(),
                                   rtol=0, atol=1e-4)
        assert T.ascomplexarray(np.complex64).dtype == np.complex64
        scales = (("unit", False), ("unit", True)) + (
            (("source", False), ("target", False)) if T is pairs[2][1]
            else (("source", False), ("source", True)))
        for scale, up in scales:
            np.testing.assert_allclose(
                T.mesh(scale=scale, upsampled=up),
                J.mesh(scale=scale, upsampled=up), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="scale"):
            T.mesh(scale="bogus")
        for name in ("auto_chunk", "allocate", "diagnostic_plot", "stats"):
            with pytest.raises(NotImplementedError, match="chunked type-3"):
                getattr(T, name)() if name != "allocate" \
                    else T.allocate([], [])
        plt.close(T.plot_kernel().figure)
    # the dense matrices are the transforms
    T1, T3 = pairs[0][1], pairs[2][1]
    np.testing.assert_allclose(
        T1.ascomplexarray(), np.exp(1j * (tnu._mode_grid_flat((5, 4))
                                          @ x2.T)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(T3.ascomplexarray(), np.exp(1j * z3 @ x3.T),
                               rtol=0, atol=1e-12)
    C = tnu.NUFFT.type3(x3, z3, chunked=True, fft_mem_mb=0.001,
                        dtype=torch.float64, device="cpu")
    CJ = jnu.NUFFT.type3(x3, z3, chunked=True, fft_mem_mb=0.001)
    assert C.stats() == CJ.stats() and C.params() == CJ.params()
    np.testing.assert_allclose(C.ascomplexarray(), CJ.ascomplexarray(),
                               rtol=0, atol=1e-4)
    for scale in ("unit", "source", "target"):
        np.testing.assert_allclose(C.mesh(scale=scale),
                                   CJ.mesh(scale=scale), rtol=1e-6,
                                   atol=1e-6)
    for dom in ("x", "z"):
        plt.close(C.diagnostic_plot(dom))
    with pytest.raises(ValueError, match="domain"):
        C.diagnostic_plot("y")


# -------------------------------------------------- the Chan circulant -----

@pytest.mark.parametrize("fdtype,real", [(F64, False), (F32, True),
                                         (F64, True), (F32, False)])
def test_chan_circulant_matches_jax(fdtype, real):
    rng = np.random.default_rng(5)
    x, N = rng.normal(0, np.pi / 3, (400, 2)).clip(-np.pi, np.pi), (12, 10)
    GJ = jnu.NUFFT.type2(x, N, eps=1e-6, real=real).gram()
    GT = tnu.NUFFT.type2(x, N, eps=1e-6, real=real, dtype=_tdt(fdtype),
                         device="cpu").gram()
    lam = GT._chan_lam()
    assert lam is GT._chan_lam() and lam.shape == N
    assert lam.dtype == _tdt(fdtype) and float(lam.min()) >= 0
    tol = _tol_jax(fdtype) if fdtype == F64 else 1e-5
    assert _rel(lam.numpy(), np.asarray(GJ._chan_lam())) <= tol
    solve, solve_j = GT._circulant_precond(), GJ._circulant_precond()
    r = rng.standard_normal((2,) + GT.dim_shape)
    for alpha in (0.0, 0.37):
        got = solve(torch.from_numpy(r.astype(fdtype)), alpha)
        want = np.asarray(solve_j(jnp.asarray(r.astype(fdtype)), alpha))
        assert got.dtype == _tdt(fdtype) and got.shape == r.shape
        assert _rel(got.numpy(), want) <= tol
        if not real:
            # (I + alpha C) undoes the solve
            z = torch.view_as_complex(got.double())
            back = torch.view_as_real(torch.fft.ifftn(
                torch.fft.fftn(z, dim=(-2, -1)) * (1.0 + alpha * lam.double()),
                dim=(-2, -1)))
            assert _rel(back.numpy(), r) <= (1e-5 if fdtype == F32 else 1e-12)
    # opt in: the quadratic's prox solves the same system preconditioned
    from pyxu_tpu_torch.operator.func import SquaredL2Norm
    A = tnu.NUFFT.type2(x, N, eps=1e-6, real=real, dtype=_tdt(fdtype),
                        device="cpu")
    y = torch.from_numpy(rng.standard_normal((400, 2)).astype(fdtype))
    quad = 0.5 * SquaredL2Norm(A.codim_shape).asloss(y) * A
    v = torch.from_numpy(rng.standard_normal(A.dim_shape).astype(fdtype))
    plain = quad.prox(v, 0.01)
    quad._prox_precond = A.gram()._circulant_precond()
    assert _rel(quad.prox(v, 0.01).numpy(), plain.numpy()) <= 1e-4


def test_shifted_kernel_has_no_circulant():
    x = np.random.default_rng(2).uniform(-np.pi, np.pi, (50, 2))
    G = tnu._NUFFTToeplitz(tnu._points(x, "cpu"), (6, 5), 1, 1e-6,
                           real_in=True, dtype=torch.float64,
                           kernel_shift=(1, 0))
    assert G._circulant_precond() is None
    with pytest.raises(ValueError, match="Hankel"):
        G._chan_lam()
