"""The port's 3-D NUFFT (types 1 and 2, the Toeplitz gram) against
pyxu_tpu, on the CPU.

The same numpy points and values go through the JAX package's NUFFT
(under ``jax.jit``) and the port's, whose spread and interp run their
plain versions on CPU tensors.  Tolerances: 1e-5 max|ref| at float32 and
1e-10 max|ref| at float64, as for 2-D (``tests/test_torch_nufft.py``).
The five 3-D Pallas routes of the JAX package run in interpret mode, as
``tests/test_pallas_ops.py`` runs them, one case each, with the route
asserted taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.operator.linop.nufft as jnu
import pyxu_tpu_torch.operator.linop.nufft as tnu

M = 1500


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(M=M, seed=3, kind="uniform"):
    rng = np.random.default_rng(seed)
    if kind == "cluster":
        return np.clip(rng.normal(0.5, 0.12, (M, 3)), -np.pi, np.pi)
    return rng.uniform(-np.pi, np.pi, (M, 3))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def _tdt(fdtype):
    return torch.from_numpy(np.zeros(0, fdtype)).dtype


F32, F64 = np.float32, np.float64
# kind, dtype, isign and grid in pairs: each value of one option meets each
# value of every other at least once; one grid is not a cube
PLANS = [("type1", F32, 1, (12, 12, 12)), ("type1", F64, -1, (12, 16, 10)),
         ("type2", F32, -1, (12, 16, 10)), ("type2", F64, 1, (12, 12, 12))]


@pytest.mark.parametrize("kind,fdtype,isign,N", PLANS)
def test_nufft3_matches_jax(kind, fdtype, isign, N):
    """Apply over a leading batch axis of 2, and the adjoint."""
    x = _x()
    jop = getattr(jnu.NUFFT, kind)(x, N, isign=isign, eps=1e-6)
    top = getattr(tnu.NUFFT, kind)(x, N, isign=isign, eps=1e-6,
                                   dtype=_tdt(fdtype), device="cpu")
    assert top.params() == jop.params()
    assert top.kernel_path == "kernel" and top._name == jop._name
    rng = np.random.default_rng(4)
    tol = 1e-5 if fdtype == F32 else 1e-10
    for name, shape in (("apply", (2,) + top.dim_shape),
                        ("adjoint", top.codim_shape)):
        a = rng.standard_normal(shape).astype(fdtype)
        want = np.asarray(jax.jit(getattr(jop, name))(jnp.asarray(a)))
        got = getattr(top, name)(torch.from_numpy(a)).numpy()
        assert got.dtype == fdtype and got.shape == want.shape
        assert _rel(got, want) <= tol, name


# route: (environment, point set, grid, points); the plans of
# tests/test_pallas_ops.py that take each 3-D Pallas route
ROUTES = {
    "strip": ({}, "uniform", (14, 12, 10), 1500),
    "grouped": ({"PYXU_TPU_NUFFT_STRIP": "0"}, "uniform", (14, 12, 10),
                1500),
    "rpencil": ({}, "cluster", (20, 18, 16), 1500),
    "ragged": ({"PYXU_TPU_NUFFT_RPENCIL": "0"}, "cluster", (20, 18, 16),
               1500),
    "slab3": ({}, "uniform", (6, 16, 16), 1500),
}


def _route_taken(plan, route):
    """Whether the JAX plan dispatches to ``route`` (the order of
    ``_spread_slab_pallas`` and ``_interp_slab_pallas``)."""
    if plan is None:
        return False
    if route in ("strip", "grouped"):
        return (plan.rpencil is None and plan.ragged is None
                and plan.pencil is not None
                and plan.pencil.strip == (route == "strip"))
    if route == "rpencil":
        return plan.rpencil is not None
    if route == "ragged":
        return (plan.rpencil is None and plan.ragged is not None
                and plan.ragged.i2T is not None)
    return (plan.rpencil is None and plan.ragged is None
            and plan.pencil is None and plan.i2T is not None)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_nufft3_matches_jax_pallas_routes(route, monkeypatch):
    """The port (float32) against the JAX package's 3-D Pallas routes,
    rows 6-11 and 16-19 of the kernel table (interpret mode on the CPU)."""
    env, kind, N, m = ROUTES[route]
    monkeypatch.setenv("PYXU_TPU_NUFFT_MM", "1")
    monkeypatch.setenv("PYXU_TPU_NUFFT_PALLAS", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = _x(M=m, kind=kind)
    jop = jnu.NUFFT.type1(x, N, isign=1, eps=1e-6)
    assert _route_taken(jop._mm3, route), route
    top = tnu.NUFFT.type1(x, N, isign=1, eps=1e-6, dtype=torch.float32,
                          device="cpu")
    rng = np.random.default_rng(5)
    c = rng.standard_normal((m, 2)).astype(np.float32)
    f = rng.standard_normal(N + (2,)).astype(np.float32)
    want = [jax.jit(jop.apply)(jnp.asarray(c)),
            jax.jit(jop.adjoint)(jnp.asarray(f))]
    assert _rel(top.apply(torch.from_numpy(c)).numpy(), want[0]) <= 1e-5
    assert _rel(top.adjoint(torch.from_numpy(f)).numpy(), want[1]) <= 1e-5


@pytest.mark.parametrize("fdtype,eps,x64", [(F32, 1e-6, True),
                                            (F64, 1e-6, True),
                                            (F32, 1e-4, False)])
def test_nufft3_toeplitz_gram_matches_jax(fdtype, eps, x64):
    """``A.gram()`` of a 3-D type 2, the Toeplitz section, against the JAX
    package's.  At float32 and eps >= 5e-5 both build its kernel at
    upsampfac 1.25 (the JAX package decides by its x64 switch, turned off
    for that case); otherwise at 2."""
    N = (10, 12, 8)
    x = _x(M=1000, seed=6)
    rng = np.random.default_rng(7)
    f = rng.standard_normal((2,) + N + (2,)).astype(fdtype)
    with jax.enable_x64(x64):
        jg = jnu.NUFFT.type2(x, N, eps=eps).gram()
        want = np.asarray(jax.jit(jg.apply)(jnp.asarray(f)))
    tg = tnu.NUFFT.type2(x, N, eps=eps, dtype=_tdt(fdtype),
                         device="cpu").gram()
    assert type(tg).__name__ == type(jg).__name__ == "_NUFFTToeplitz"
    sigma = 1.25 if eps >= 5e-5 and fdtype == F32 else 2.0
    assert tg._build_params.upsample_factor == sigma
    got = tg.apply(torch.from_numpy(f)).numpy()
    assert got.dtype == fdtype
    assert _rel(got, want) <= (1e-5 if fdtype == F32 else 1e-10)
    assert tg.trace() == jg.trace()


@pytest.mark.parametrize("kind", ["type1", "type2"])
def test_nufft3_adjoint_dot_test(kind):
    op = getattr(tnu.NUFFT, kind)(_x(M=800, seed=9), (8, 10, 6), eps=1e-8,
                                  dtype=torch.float64, device="cpu")
    u = torch.randn(op.dim_shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    v = torch.randn(op.codim_shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    lhs, rhs = float(torch.sum(op.apply(u) * v)), float(
        torch.sum(u * op.adjoint(v)))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("isign", [1, -1])
def test_nufft3_matches_direct_nudft(isign):
    N = (8, 10, 6)
    x = _x(M=500, seed=10)
    rng = np.random.default_rng(11)
    c = rng.standard_normal((500, 2))
    f = rng.standard_normal(N + (2,))
    op = tnu.NUFFT.type1(x, N, isign=isign, eps=1e-9, dtype=torch.float64,
                         device="cpu")
    out = op.apply(torch.from_numpy(c)).numpy()
    ref = jnu.nudft1(c[:, 0] + 1j * c[:, 1], x, N, isign)
    assert _rel(out[..., 0] + 1j * out[..., 1], ref) <= 1e-8
    out = op.adjoint(torch.from_numpy(f)).numpy()
    ref = jnu.nudft2(f[..., 0] + 1j * f[..., 1], x, N, -isign)
    assert _rel(out[..., 0] + 1j * out[..., 1], ref) <= 1e-8
    # the port's direct evaluators are the JAX package's at d = 3 too
    np.testing.assert_allclose(
        tnu.nudft1(c[:, 0], x, N, isign), jnu.nudft1(c[:, 0], x, N, isign),
        rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        tnu.nudft2(f[..., 0], x, N, isign), jnu.nudft2(f[..., 0], x, N, isign),
        rtol=1e-12, atol=1e-9)


def test_nufft3_no_points():
    """M = 0 (the JAX package raises there): zeros, as the direct NUDFT."""
    N = (6, 8, 4)
    x = np.zeros((0, 3))
    t1 = tnu.NUFFT.type1(x, N, dtype=torch.float64, device="cpu")
    out = t1.apply(torch.zeros((0, 2), dtype=torch.float64))
    assert out.shape == N + (2,) and not out.any()
    np.testing.assert_array_equal(out[..., 0].numpy(),
                                  jnu.nudft1(np.zeros(0), x, N).real)
    t2 = tnu.NUFFT.type2(x, N, dtype=torch.float64, device="cpu")
    assert t2.apply(torch.ones(N + (2,), dtype=torch.float64)).shape == (0, 2)
    assert not t2.gram().apply(torch.ones(N + (2,),
                                          dtype=torch.float64)).any()


@pytest.mark.parametrize("fdtype", [F32, F64])
def test_plan3_taps_match_jax(fdtype):
    """The port's 3-D plan (left taps and float64 offsets, in bin order)
    gives the JAX package's tap indices and weights, with points at 0 and
    just below 2 pi."""
    x = np.concatenate([_x(M=600, seed=12),
                        [[0.0, -0.0, np.nextafter(np.pi, 0)],
                         [np.nextafter(2 * np.pi, 0), -np.pi, 1e-300]]])
    op = tnu.NUFFT.type1(x, (10, 14, 8), eps=1e-6, dtype=_tdt(fdtype),
                         device="cpu")
    p = op._plan
    assert p.d == 3 and p.bins == tnu._kern.bin3(op._w, _tdt(fdtype))
    idxs, wts = jnu._tap_weights_np(np.mod(x, 2 * np.pi), op._nf, op._w,
                                    op._beta)
    perm = p.perm.long().numpy()
    t = np.arange(op._w)
    for ax in range(3):
        got_idx = (p.i0[ax].numpy()[:, None] + t) % op._nf[ax]
        np.testing.assert_array_equal(got_idx, idxs[ax][perm])
        off = p.off[ax].double() if fdtype == F64 else p.off[ax]
        got_w = tnu._kern.es_weights(off, op._w, op._beta).numpy()
        np.testing.assert_allclose(got_w, wts[ax][perm], rtol=0,
                                   atol=1e-13 if fdtype == F64 else 1e-6)
