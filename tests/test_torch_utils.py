"""The port's last utility modules against pyxu_tpu's, on the CPU, and the
256x256 TV solve against the JAX package's.

``utils/vectorize.py`` (``vectorize``, ``batched_over``, the batch
helpers), ``utils/array_module.py``, ``utils/inspect.py``,
``utils/profiler.py`` (``timed``, ``trace``), ``info/ptype.py`` and
``info/deps.py`` (the registries' members over torch and numpy arrays),
``info/plugin.py`` (discovery of a fake entry point, the ``_`` override
rule, a broken plugin), ``experimental/_dev.py`` (at float64).  One numpy
input goes through both packages; tolerance ``atol_for`` times the
output's largest magnitude (at least 1).
"""

import importlib.metadata
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import atol_for

import pyxu_tpu.experimental._dev as jdev
import pyxu_tpu.info as jinfo
import pyxu_tpu.info.plugin as jplugin
import pyxu_tpu.info.ptype as jptype
import pyxu_tpu.utils as jutil
import pyxu_tpu_torch.experimental._dev as tdev
import pyxu_tpu_torch.info as tinfo
import pyxu_tpu_torch.info.plugin as tplugin
import pyxu_tpu_torch.info.ptype as tptype
import pyxu_tpu_torch.utils as tutil
from pyxu_tpu.models.workloads import tv_deconvolution as jtv
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.info.warnings import BackendWarning
from pyxu_tpu_torch.models import tv_deconvolution
from pyxu_tpu_torch.opt.stop import MaxIter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype=np.float32):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=atol_for(dtype) * max(1.0, float(np.abs(want).max())))


RNG = np.random.default_rng(2024)
X3 = RNG.standard_normal((2, 3, 5))


# ------------------------------------------------------------ vectorize --

def test_flatten_unflatten():
    flat, bs = tutil.flatten_batch(torch.from_numpy(X3), 1)
    jflat, jbs = jutil.flatten_batch(X3, 1)
    assert bs == tuple(jbs) == (2, 3)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(tutil.unflatten_batch(flat, bs).numpy(),
                                  X3)
    f0, b0 = tutil.flatten_batch(torch.from_numpy(X3), 0)
    assert f0.shape == (30,) and b0 == X3.shape


@pytest.mark.parametrize("core", [1, 2])
def test_batched_over_matches(core):
    def tfn(a, s):
        return s * a.flip(-1).cumsum(-1)

    def jfn(a, s):
        return s * jnp.cumsum(jnp.flip(a, -1), -1)
    got = tutil.batched_over(tfn, core)(torch.from_numpy(X3), 2.0)
    want = jax.jit(lambda v: jutil.batched_over(jfn, core)(v, 2.0))(X3)
    _close(got, want, np.float64)
    sample = X3[(0,) * (3 - core)]                  # no batch axis
    one = tutil.batched_over(tfn, core)(torch.from_numpy(sample), 2.0)
    _close(one, jfn(sample, 2.0), np.float64)
    with pytest.raises(ValueError, match="core rank"):
        tutil.batched_over(tfn, 4)(torch.from_numpy(X3), 1.0)


def test_vectorize_matches():
    @tutil.vectorize("x")
    def tf(x, w=3.0):
        return torch.cat([w * x, x[:2]])

    @jutil.vectorize("x")
    def jf(x, w=3.0):
        return jnp.concatenate([w * x, x[:2]])
    got = tf(torch.from_numpy(X3), w=0.5)
    assert got.shape == (2, 3, 7)
    _close(got, jax.jit(lambda v: jf(v, w=0.5))(X3), np.float64)
    with pytest.raises(ValueError, match="Unknown vectorization"):
        tutil.vectorize("x", method="dask")
    with pytest.raises(ValueError, match="not part of"):
        tutil.vectorize("y")(lambda x: x)


# --------------------------------------------------------- array module --

def test_array_module_helpers():
    t = torch.from_numpy(X3.copy())
    assert tutil.get_array_module(t) is torch
    assert tutil.get_array_module(X3) is np
    assert tutil.compute(t) is t and tutil.compute(t, t) == (t, t)
    np.testing.assert_array_equal(tutil.to_numpy(t), X3)
    np.testing.assert_array_equal(tutil.to_NUMPY(t), np.asarray(
        jutil.to_numpy(jnp.asarray(X3))))
    assert tutil.copy_if_unsafe(t) is t
    view = t[0]
    safe = tutil.copy_if_unsafe(view)
    assert safe is not view and safe._base is None
    assert torch.equal(safe, view)
    a = X3.copy()
    assert tutil.copy_if_unsafe(a) is a
    assert tutil.copy_if_unsafe(a[0]) is not a[0]
    ro = tutil.read_only(a)
    assert not ro.flags.writeable and a.flags.writeable
    assert tutil.copy_if_unsafe(ro).flags.writeable
    assert tutil.read_only(t) is t

    @tutil.redirect(NUMPY=lambda arr: "host")
    def f(arr):
        return "generic"

    @jutil.redirect(NUMPY=lambda arr: "host")
    def jf(arr):
        return "generic"
    assert (f(a), f(t)) == (jf(a), jf(jnp.asarray(a))) == ("host", "generic")


def test_inspect_helpers():
    def g(a, b=2, *c, d=4):
        return a
    want = jutil.parse_params(g, 1, 3, 5, d=6)
    assert tutil.parse_params(g, 1, 3, 5, d=6) == want
    assert tutil.import_module("json") is json
    assert tutil.import_module("no_such_module_xyz",
                               fail_on_error=False) is None
    with pytest.raises(ModuleNotFoundError):
        tutil.import_module("no_such_module_xyz")


def test_timed_and_trace(tmp_path):
    with tutil.timed() as out:
        out["x"] = torch.ones(64).cumsum(0)
    assert out["seconds"] > 0 and out["x"][-1] == 64
    with tutil.timed(sync=[torch.zeros(3)]) as out:
        pass
    assert out["seconds"] >= 0
    with tutil.trace(str(tmp_path / "tr")):
        torch.ones(32).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


# ------------------------------------------------------------- info --

def test_deps_registries():
    Info, Sparse = tinfo.NDArrayInfo, tinfo.SparseArrayInfo
    assert [m.name for m in Info] == ["NUMPY", "TORCH"]
    assert Info.from_obj(torch.ones(2)) is Info.TORCH
    assert Info.from_obj(np.ones(2)) is Info.NUMPY
    assert Info.from_flag(gpu=True) is Info.TORCH
    assert Info.TORCH.module() is torch and Info.NUMPY.type() is np.ndarray
    assert tinfo.supported_array_types() == (np.ndarray, torch.Tensor)
    assert tinfo.supported_array_modules() == (np, torch)
    with pytest.raises(ValueError, match="unsupported"):
        Info.from_obj([1.0])
    with pytest.raises(ValueError, match="unsupported"):
        Info.from_obj(torch.eye(2).to_sparse())
    assert Sparse.from_obj(sp.eye(3).tocsr()) is Sparse.SCIPY
    assert Sparse.from_obj(torch.eye(3).to_sparse_csr()) is \
        Sparse.TORCH_SPARSE
    assert Sparse.SCIPY.module() is sp
    assert Sparse.TORCH_SPARSE.module() is torch.sparse
    assert len(tinfo.supported_sparse_modules()) == 2
    assert torch.Tensor in tinfo.supported_sparse_types()
    assert (tinfo.CUPY_ENABLED, tinfo.JAX_SUPPORT, tinfo.PYTORCH_SUPPORT) \
        == (False, False, True)
    # the JAX package's registry has the same shape: host numpy and one
    # compute backend
    assert len(list(Info)) == len(list(jinfo.NDArrayInfo)) == 2


def test_ptype_vocabulary():
    assert tptype.__all__ == jptype.__all__
    assert tptype.NDArray is torch.Tensor
    assert isinstance(3, tptype.Integer) and isinstance(0.5, tptype.Real)
    assert torch.dtype in tptype.DType.__args__


# ------------------------------------------------------------ plugins --

def _fake_eps(prefix):
    EP = importlib.metadata.EntryPoint
    g = f"{prefix}.opt.stop"
    return importlib.metadata.EntryPoints([
        EP("MyStop", "json:dumps", g),             # a new name
        EP("_MaxIter", "json:loads", g),           # an explicit override
        EP("RelError", "json:dumps", g),           # shadows: refused
        EP("Broken", "no_such_module_xyz:thing", g),
    ])


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_plugins_discovery_and_override_rule(pkg, monkeypatch):
    plugin, prefix = {"torch": (tplugin, "pyxu_tpu_torch"),
                      "jax": (jplugin, "pyxu_tpu")}[pkg]
    assert plugin.PLUGIN_GROUPS == tuple(
        f"{prefix}.{g}" for g in ("operator", "opt.solver", "opt.stop",
                                  "math"))
    monkeypatch.setattr(importlib.metadata, "entry_points",
                        lambda: _fake_eps(prefix))
    found = plugin.discover_plugins()
    assert set(found) == set(plugin.PLUGIN_GROUPS)
    group = f"{prefix}.opt.stop"
    assert sorted(found[group]) == ["Broken", "MyStop", "RelError",
                                    "_MaxIter"]
    mod = importlib.import_module(group)
    keep = mod.MaxIter
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            loaded = plugin.load_plugins(group)
        assert sorted(loaded) == [f"{group}.MaxIter", f"{group}.MyStop"]
        assert mod.MyStop is json.dumps and mod.MaxIter is json.loads
        assert mod.RelError is not json.dumps
        msgs = " | ".join(str(x.message) for x in w)
        assert "shadows an existing symbol" in msgs and "failed to load" in msgs
        if pkg == "torch":
            assert all(issubclass(x.category, BackendWarning) for x in w)
    finally:
        mod.MaxIter = keep
        del mod.MyStop


# ------------------------------------------------------------ _dev --

def test_dev_arrays_match():
    x = RNG.uniform(-np.pi, np.pi, (7, 2))
    z = RNG.uniform(-5, 5, (6, 2))
    for N in (4, (3, 5)):
        _close(tdev.NUFFT1_array(x, N, -1), jdev.NUFFT1_array(x, N, -1),
               np.float64)
        _close(tdev.NUFFT2_array(x, N, 1), jdev.NUFFT2_array(x, N, 1),
               np.float64)
    _close(tdev.NUFFT3_array(x, z, 1), jdev.NUFFT3_array(x, z, 1),
           np.float64)
    _close(tdev.NUFFT3_array(x[:, 0], z[:, 0], -1),
           jdev.NUFFT3_array(x[:, 0], z[:, 0], -1), np.float64)


@pytest.mark.parametrize("kind", ["forward", "backward", "centered"])
def test_dev_operators_match(kind):
    v = RNG.standard_normal(12)
    op = tdev.FirstDerivative(12, sampling=0.5, kind=kind, device="cpu")
    jop = jdev.FirstDerivative(12, sampling=0.5, kind=kind)
    _close(op.apply(torch.from_numpy(v)), jop.apply(jnp.asarray(v)),
           np.float64)
    _close(op.adjoint(torch.from_numpy(v)), jop.adjoint(jnp.asarray(v)),
           np.float64)
    mask = RNG.random(12) > 0.4
    _close(tdev.Masking(12, mask).apply(torch.from_numpy(v)),
           jdev.Masking(12, mask).apply(jnp.asarray(v)), np.float64)
    with pytest.raises(ValueError, match="Invalid size"):
        tdev.Masking(11, mask)
    img = RNG.standard_normal((9, 8))
    for axis in (None, 0, -1):
        _close(tdev.DownSampling((9, 8), 3, axis).apply(torch.from_numpy(img)),
               jdev.DownSampling((9, 8), 3, axis).apply(jnp.asarray(img)),
               np.float64)
    assert tdev.SquaredL2Norm is not None and tdev.L1Norm is not None
    import pyxu_tpu_torch.experimental as texp
    import pyxu_tpu_torch.experimental.sampler as tsamp
    assert tsamp is texp.sampler and hasattr(tsamp, "MYULA")


# ------------------------------------------------- the 256^2 TV solve --

def test_tv_256_matches_jax():
    """The TV path at 256x256 (slice 1 held 64x48 only): the JAX package's
    generic solve and the port's fused solve (its main path, here the
    plain version of the fused step), 20 iterations, f32."""
    shape, iters = (256, 256), 20
    slv_j, kw, ej = jtv(shape=shape)
    slv_j.fit(stop_crit=JMaxIter(iters), max_iter=iters, **kw)
    slv, fit, et = tv_deconvolution(shape, device="cpu", stop_rate=10)
    np.testing.assert_array_equal(et["x_true"].numpy(), ej["x_true"])
    slv.fit(stop_crit=MaxIter(iters), max_iter=iters, **fit)
    assert slv.fused_path == "plain"
    _close(slv.solution().numpy(), slv_j.solution())
    _close(slv._mstate["z"].numpy(), slv_j._mstate["z"])
