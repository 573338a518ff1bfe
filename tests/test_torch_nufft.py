"""The port's 2-D NUFFT (types 1 and 2) against pyxu_tpu, on the CPU.

The same numpy points and values go through the JAX package's NUFFT
(under ``jax.jit``) and the port's, whose spread and interp run their
plain versions on CPU tensors.  Tolerances: 1e-5 max|ref| at float32 and
1e-10 max|ref| at float64 (the two plans compute the same sums in another
order; the JAX package runs under x64 here, ``tests/conftest.py``, so its
tap weights are float64 even for float32 inputs, while the port's float32
plan computes them in float32 from float64 offsets).  The Pallas routes of
the JAX package run in interpret mode, as ``tests/test_pallas_ops.py`` runs
them.  ``test_port_right_after_jax_in_a_fresh_process`` makes the first
torch computation of a process right after a JAX one.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyxu_tpu.operator.linop.nufft as jnu
import pyxu_tpu.utils.complex as jcx
from pyxu_tpu.utils.misc import next_fast_len as jnext_fast_len
import pyxu_tpu_torch.operator.linop.nufft as tnu
import pyxu_tpu_torch.utils.complex as tcx
from pyxu_tpu_torch.utils.misc import next_fast_len

M, N = 1500, (32, 40)


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
        return np.clip(rng.normal(0.3, 0.35, (M, 2)), -np.pi, np.pi)
    return rng.uniform(-np.pi, np.pi, (M, 2))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


def _tol(dtype):
    return 1e-5 if np.dtype(dtype) == np.float32 else 1e-10


def _pair(kind, x, dtype, **kw):
    """The JAX package's and the port's NUFFT of one kind on points x."""
    make_j = getattr(jnu.NUFFT, kind)
    make_t = getattr(tnu.NUFFT, kind)
    return make_j(x, N, **kw), make_t(x, N, dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype, device="cpu", **kw)


# kind, dtype, isign, real and upsampfac in pairs: each value of one option
# meets each value of every other at least once
F32, F64 = np.float32, np.float64
PLANS = [("type1", F32, 1, False, 2.0), ("type1", F64, -1, True, 2.0),
         ("type1", F32, -1, True, 1.25), ("type1", F64, 1, False, 1.25),
         ("type2", F64, 1, True, 2.0), ("type2", F32, -1, False, 2.0),
         ("type2", F64, -1, False, 1.25), ("type2", F32, 1, True, 1.25)]


@pytest.mark.parametrize("kind,fdtype,isign,real,upsampfac", PLANS)
def test_nufft_matches_jax(kind, fdtype, isign, real, upsampfac):
    """Apply and adjoint over a leading batch axis of 2."""
    eps = 1e-6 if upsampfac == 2.0 else 1e-4
    # at upsampfac 1.25 the deconvolution divides by small phihat: the
    # float32 floor the JAX package states for it (nufft.py:1851-1861)
    tol = 5e-5 if (upsampfac == 1.25 and fdtype == np.float32) \
        else _tol(fdtype)
    jop, top = _pair(kind, _x(), fdtype, isign=isign, eps=eps, real=real,
                     upsampfac=upsampfac)
    assert top.params() == jop.params()
    assert top.kernel_path == "kernel"
    rng = np.random.default_rng(4)
    for name, shape in (("apply", top.dim_shape),
                        ("adjoint", top.codim_shape)):
        a = rng.standard_normal((2,) + shape).astype(fdtype)
        want = np.asarray(jax.jit(getattr(jop, name))(jnp.asarray(a)))
        got = getattr(top, name)(torch.from_numpy(a)).numpy()
        assert got.dtype == fdtype and got.shape == want.shape
        assert _rel(got, want) <= tol, name


FRESH = """
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)   # a first multi-threaded index_add_ can sum wrong
import pyxu_tpu.operator.linop.nufft as jnu
import pyxu_tpu_torch.operator.linop.nufft as tnu
rng = np.random.default_rng(3)
x = rng.uniform(-np.pi, np.pi, (1500, 2))
c = rng.standard_normal((1500, 2)).astype(np.float32)
want = jax.jit(jnu.NUFFT.type1(x, (32, 40), eps=1e-6).apply)(jnp.asarray(c))
got = tnu.NUFFT.type1(x, (32, 40), eps=1e-6, dtype=torch.float32,
                      device="cpu").apply(torch.from_numpy(c)).numpy()
ref = jnu.nudft1(c[:, 0] + 1j * c[:, 1], x, (32, 40), 1)
rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
print(json.dumps([rel(got, np.asarray(want)),
                  rel(got[..., 0] + 1j * got[..., 1], ref)]))
"""


def test_port_right_after_jax_in_a_fresh_process():
    """The port's first torch computation in a process, made while the
    JAX package's result may still be in flight, against that result and
    the direct NUDFT."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(root)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", FRESH], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    vs_jax, vs_nudft = json.loads(out.stdout.strip().splitlines()[-1])
    assert vs_jax <= 1e-5 and vs_nudft <= 2e-5, (vs_jax, vs_nudft)


ROUTES = {
    "slab-spread-strip2-interp": ({}, "uniform"),
    "slab-interp": ({"PYXU_TPU_NUFFT_STRIP2": "0"}, "uniform"),
    "strip2-spread": ({"PYXU_TPU_NUFFT_STRIP2_SPREAD": "1"}, "uniform"),
    "ragged": ({}, "cluster"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_nufft_matches_jax_pallas_routes(route, monkeypatch):
    """The port (float32) against the JAX package's Pallas routes, rows
    4, 5 and 12-15 of the kernel table (interpret mode on the CPU)."""
    env, kind = ROUTES[route]
    monkeypatch.setenv("PYXU_TPU_NUFFT_MM", "1")
    monkeypatch.setenv("PYXU_TPU_NUFFT_PALLAS", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = _x(kind=kind, M=1500 if kind == "uniform" else 3000)
    jop = jnu.NUFFT.type1(x, N, isign=1, eps=1e-6)
    plan = jop._mm3
    if kind == "cluster":
        assert plan is not None and plan.ragged is not None
    else:
        assert plan is not None and plan.l0T is not None
        assert (plan.strip2 is not None) == (route != "slab-interp")
    top = tnu.NUFFT.type1(x, N, isign=1, eps=1e-6, dtype=torch.float32,
                          device="cpu")
    rng = np.random.default_rng(5)
    c = rng.standard_normal((x.shape[0], 2)).astype(np.float32)
    f = rng.standard_normal(N + (2,)).astype(np.float32)
    want = [jax.jit(jop.apply)(jnp.asarray(c)),
            jax.jit(jop.adjoint)(jnp.asarray(f))]
    assert _rel(top.apply(torch.from_numpy(c)).numpy(), want[0]) <= 1e-5
    assert _rel(top.adjoint(torch.from_numpy(f)).numpy(), want[1]) <= 1e-5


@pytest.mark.parametrize("isign", [1, -1])
def test_nufft_matches_direct_nudft(isign, fdtype):
    x = _x(seed=7)
    rng = np.random.default_rng(8)
    c = rng.standard_normal((M, 2))
    f = rng.standard_normal(N + (2,))
    dt = torch.from_numpy(np.zeros(0, fdtype)).dtype
    op = tnu.NUFFT.type1(x, N, isign=isign, eps=1e-6, dtype=dt, device="cpu")
    out = op.apply(torch.from_numpy(c.astype(fdtype))).numpy()
    ref = jnu.nudft1(c[:, 0] + 1j * c[:, 1], x, N, isign)
    assert _rel(out[..., 0] + 1j * out[..., 1], ref) <= 2e-5
    out = op.adjoint(torch.from_numpy(f.astype(fdtype))).numpy()
    ref = jnu.nudft2(f[..., 0] + 1j * f[..., 1], x, N, -isign)
    assert _rel(out[..., 0] + 1j * out[..., 1], ref) <= 2e-5
    # the port's own direct evaluators are the JAX package's
    np.testing.assert_allclose(
        tnu.nudft1(c[:, 0], x, N, isign), jnu.nudft1(c[:, 0], x, N, isign),
        rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        tnu.nudft2(f[..., 0], x, N, isign), jnu.nudft2(f[..., 0], x, N, isign),
        rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("kind", ["type1", "type2"])
def test_nufft_adjoint_dot_test(kind, real):
    op = getattr(tnu.NUFFT, kind)(_x(seed=9), N, eps=1e-8, real=real,
                                  dtype=torch.float64, device="cpu")
    u = torch.randn(op.dim_shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    v = torch.randn(op.codim_shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    lhs, rhs = float(torch.sum(op.apply(u) * v)), float(
        torch.sum(u * op.adjoint(v)))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_nufft_no_points():
    """M = 0 (the JAX package raises there): zeros, as the direct NUDFT."""
    x = np.zeros((0, 2))
    t1 = tnu.NUFFT.type1(x, N, dtype=torch.float64, device="cpu")
    out = t1.apply(torch.zeros((0, 2), dtype=torch.float64))
    assert out.shape == N + (2,) and not out.any()
    np.testing.assert_array_equal(out[..., 0].numpy(),
                                  jnu.nudft1(np.zeros(0), x, N).real)
    t2 = tnu.NUFFT.type2(x, N, real=True, dtype=torch.float64, device="cpu")
    assert t2.apply(torch.ones(N, dtype=torch.float64)).shape == (0, 2)
    assert not t2.gram().apply(torch.ones(N, dtype=torch.float64)).any()


@pytest.mark.parametrize("eps", [1e-2, 1e-4, 1e-6, 1e-9, 1e-14])
@pytest.mark.parametrize("upsampfac", [2.0, 1.25])
def test_plan_parameters_match_jax(eps, upsampfac):
    assert tnu._es_params(eps, upsampfac) == jnu._es_params(eps, upsampfac)
    w, beta = tnu._es_params(eps, upsampfac)
    for n_modes, n_f in ((32, 64), (63, 80), (2047, 4096)):
        kt, ft = tnu._phi_hat(n_modes, n_f, w, beta)
        kj, fj = jnu._phi_hat(n_modes, n_f, w, beta)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(ft, fj)
    z = np.linspace(-1.2, 1.2, 41)
    np.testing.assert_array_equal(tnu.ES_kernel(z, beta),
                                  jnu.ES_kernel(z, beta))


def test_next_fast_len_matches_jax():
    for n in list(range(1, 300)) + [1023, 2047, 4094, 4097, 20000]:
        assert next_fast_len(n) == jnext_fast_len(n)


@pytest.mark.parametrize("upsampfac", [2.0, 1.25])
def test_plan_taps_match_jax(upsampfac):
    """The port's plan (left taps and float64 offsets, in bin order) gives
    the JAX package's tap indices and weights."""
    x = np.concatenate([_x(seed=11), [[0.0, -0.0],
                                      [np.nextafter(np.pi, 0), -np.pi]]])
    op = tnu.NUFFT.type1(x, N, eps=1e-6, upsampfac=upsampfac,
                         dtype=torch.float64, device="cpu")
    p = op._plan
    idxs, wts = jnu._tap_weights_np(np.mod(x, 2 * np.pi), op._nf, op._w,
                                    op._beta)
    perm = p.perm.long().numpy()
    t = np.arange(op._w)
    for ax in range(2):
        got_idx = (p.i0[ax].numpy()[:, None] + t) % op._nf[ax]
        np.testing.assert_array_equal(got_idx, idxs[ax][perm])
        got_w = tnu._kern.es_weights(p.off[ax], op._w, op._beta).numpy()
        np.testing.assert_allclose(got_w, wts[ax][perm], rtol=0, atol=1e-13)


def test_complex_views_match_jax():
    rng = np.random.default_rng(12)
    z = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4)))
    for cdt in (np.complex64, np.complex128):
        zc = z.astype(cdt)
        got = tcx.view_as_real(torch.from_numpy(zc)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcx.view_as_real(zc)))
        back = tcx.view_as_complex(torch.from_numpy(got[:, ::2])).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(jcx.view_as_complex(got[:, ::2])))
        rdt = tcx.real_dtype(torch.from_numpy(zc).dtype)
        assert np.dtype(str(rdt)[6:]) == jcx.real_dtype(cdt)
        assert tcx.complex_dtype(rdt) == torch.from_numpy(zc).dtype
    assert tcx.complex_dtype(torch.bfloat16) == torch.complex64
    with pytest.raises(ValueError):
        tcx.view_as_real(torch.zeros(3))
    with pytest.raises(ValueError):
        tcx.view_as_complex(torch.zeros(3, 3))


def test_unported_forms_and_plan_options():
    # d = 1 and type 3 build now (tests/test_torch_nufft_t3.py holds them)
    op = tnu.NUFFT.type1(np.zeros((5, 1)), 8, device="cpu")
    assert op.kernel_path == "plain" and op.codim_shape == (8, 2)
    op = tnu.NUFFT.type2(np.zeros(5), 8, device="cpu")
    assert op.kernel_path == "plain" and op.dim_shape == (8, 2)
    op = tnu.NUFFT.type3(np.zeros((5, 2)), np.zeros((4, 2)), device="cpu")
    assert op.kernel_path == "kernel" and op.codim_shape == (4, 2)
    with pytest.raises(NotImplementedError, match="modeord"):
        tnu.NUFFT.type1(_x(), N, device="cpu", modeord=1)
    with pytest.raises(TypeError):
        tnu.NUFFT.type1(_x(), N, device="cpu", bogus=1)
    with pytest.warns(Warning, match="n_trans"):
        tnu.NUFFT.type1(_x(), N, device="cpu", n_trans=2)
    with pytest.raises(ValueError, match="upsampfac"):
        tnu.NUFFT.type1(_x(), N, device="cpu", upsampfac=1.5)
    with pytest.raises(ValueError, match="cannot reach"):
        tnu.NUFFT.type1(_x(), N, device="cpu", upsampfac=1.25, eps=1e-6,
                        dtype=torch.float32)
