"""The port's example programs against the JAX package's, on the CPU.

Each of ``pyxu_tpu_torch/examples/`` runs at the reduced sizes of
``tests/test_examples.py`` with ``device="cpu"``, and the JAX program
(``examples/``) at the same sizes; their results are compared.

Tolerances, each a multiple of max(1, max|reference|).  Every solve here
runs the same iteration count in both packages (a failure message gives
them: a ``RelError`` stop could differ by a block), so the images
(deconvolution, tomography, RI, halo TV, the notebook) and the streamed
outputs are held to the f32 conformance tolerance, 2e-4 (observed: at
most 7.4e-5 over 500 Condat-Vu iterations); the consensus z to 1e-5 (its
closed form is met to 5e-7 by both); the type-3 NUFFT to 1e-5 (eps 1e-6;
the two plans' fine grids may differ).
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import pyxu_tpu.abc.solver as jsolver
import pyxu_tpu_torch.abc.solver as tsolver
from pyxu_tpu_torch.examples import (deconvolution, distributed, out_of_core,
                                     radio_interferometry, tomography)

from _torch_mesh import mesh1  # noqa: F401  (the fixture)

ROOT = pathlib.Path(__file__).parent.parent
IMG = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the problems here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fits(monkeypatch):
    """Every solver that runs ``fit`` in the test, by package."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jsolver), ("torch", tsolver)):
        orig = mod.Solver.fit

        def fit(self, *a, _orig=orig, _seen=seen[key], **k):
            _seen.append(self)
            return _orig(self, *a, **k)
        monkeypatch.setattr(mod.Solver, "fit", fit)
    return seen


def _iters(fits):
    return {k: [int(s.stats()[1]["iteration"][-1]) for s in v]
            for k, v in fits.items()}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, tol, fits=None, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, (f"{what}: max|port - jax| {err:.3e} > {lim:.3e}; "
                        f"iterations {_iters(fits) if fits else None}")


def test_deconvolution_example(fits, capsys):
    got = deconvolution.main(n=48, device="cpu")
    want = _jax_example("deconvolution").main(n=48)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("relative error: blurred")
    assert out[0].split()[3] == out[1].split()[3], out     # blurred error
    assert fits["torch"][0].fused_path == "plain"
    _close(got, want, IMG, fits, "x_hat")


@pytest.mark.parametrize("method", ["interp", "fourier"])
def test_tomography_example(method, fits):
    got = tomography.main(n=32, n_angles=12, method=method, device="cpu")
    assert got.shape == (32, 32) and float(got.min()) >= -1e-6
    if method == "interp":      # the JAX program's default
        want = _jax_example("tomography").main(n=32, n_angles=12)
    else:
        from pyxu_tpu.models import sparse_view_ct
        from pyxu_tpu.opt.stop import MaxIter, RelError
        slv, kw, _ = sparse_view_ct(shape=(32, 32), n_angles=12, lam=0.005,
                                    method="fourier")
        slv.fit(stop_crit=RelError(eps=1e-6, var="x", rank=2)
                | MaxIter(300), max_iter=300, **kw)
        want = slv.solution()
    _close(got, want, IMG, fits, f"CT {method}")


def test_radio_interferometry_example(fits):
    got = radio_interferometry.main(n=24, n_vis=400, device="cpu")
    want = _jax_example("radio_interferometry").main(n=24, n_vis=400)
    assert got.shape == (24, 24)
    _close(got, want, IMG, fits, "RI image")


def test_out_of_core_example(monkeypatch):
    """The three patterns' outputs: the streamed blur, the blocks and the
    streamed TV solve, against the JAX program's (captured at its calls)."""
    got = out_of_core.main(H=96, W=40, block_rows=32, device="cpu")
    jmod = _jax_example("out_of_core")
    seen = {}
    for name in ("streamed_map_overlap", "streamed_block_diag"):
        def rec(*a, _f=getattr(jmod, name), _n=name, **k):
            seen[_n] = _f(*a, **k)
            return seen[_n]
        monkeypatch.setattr(jmod, name, rec)
    fit = jmod.StreamedCondatVu.fit

    def rec_fit(self, *a, **k):
        seen["tv"] = self
        return fit(self, *a, **k)
    monkeypatch.setattr(jmod.StreamedCondatVu, "fit", rec_fit)
    jmod.main(H=96, W=40, block_rows=32)
    y, outs, sol = got
    _close(y, seen["streamed_map_overlap"], IMG, what="streamed blur")
    for o, w in zip(outs, seen["streamed_block_diag"], strict=True):
        _close(o, w, IMG, what="block")
    _close(sol, seen["tv"].solution(), IMG, what="streamed TV")


def test_distributed_example(mesh1, fits, monkeypatch):  # noqa: F811
    """The three patterns at one gloo rank against the JAX program on a
    mesh of one device."""
    import pyxu_tpu.parallel as jpar
    jmod = _jax_example("distributed")
    jmesh = jpar.auto_mesh(1)
    x = distributed.tv_deconvolution_halo(mesh1, n=48)
    jmod.tv_deconvolution_halo(jmesh, n=48)
    _close(x, fits["jax"][-1].solution(), IMG, fits, "halo TV")

    z = distributed.consensus_lasso(mesh1, n=16)
    jmod.consensus_lasso(jmesh, n=16)
    _close(z, fits["jax"][-1].solution(), 1e-5, fits, "consensus z")

    applied = []
    apply = jpar.ShardedNUFFT3.apply

    def rec(self, a):
        applied.append(np.asarray(apply(self, a)))
        return applied[-1]
    monkeypatch.setattr(jpar.ShardedNUFFT3, "apply", rec)
    got, got_slice = distributed.sharded_type3_nufft(mesh1, M=600, K=400)
    jmod.sharded_type3_nufft(jmesh, M=600, K=400)
    _close(got, applied[0], 1e-5, what="type-3 apply")
    _close(got_slice, applied[1], 1e-5, what="type-3 apply, 500 sources")


def _cells(path, port):
    """The notebook's code cells, with tests/test_examples.py's shrink
    substitutions (and, for the port, ``device="cpu"``)."""
    nb = json.loads(path.read_text())
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        src = "".join(cell["source"])
        src = src.replace("n, lam, sigma_blur = 256,",
                          "n, lam, sigma_blur = 64,")
        src = src.replace("MaxIter(400)", "MaxIter(40)").replace(
            "max_iter=400", "max_iter=40")
        if port:
            src = src.replace('device = None', 'device = "cpu"')
        yield src


def test_notebook_cells_execute(fits):
    """The port's walkthrough runs top to bottom as the JAX one does, and
    their reconstructions agree."""
    ns, jns = {}, {}
    for src in _cells(ROOT / "pyxu_tpu_torch" / "examples" /
                      "tv_deconvolution.ipynb", port=True):
        exec(src, ns)
    for src in _cells(ROOT / "examples" / "tv_deconvolution.ipynb",
                      port=False):
        exec(src, jns)
    assert ns["err"] < 0.5
    assert ns["slv"].fused_path == "plain"
    _close(ns["x_rec"], jns["x_rec"], IMG, fits, "notebook x_rec")
    assert abs(ns["err"] - jns["err"]) <= IMG, (ns["err"], jns["err"])


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_example_module_needs_the_card_unless_asked(monkeypatch):
    """``python -m pyxu_tpu_torch.examples.<name>`` runs ``main()``, which
    runs on the card: with none present it raises before any work, and
    never carries on on the CPU unasked."""
    import runpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("deconvolution", "tomography", "radio_interferometry",
                 "out_of_core", "distributed"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runpy.run_module(f"pyxu_tpu_torch.examples.{name}",
                             run_name="__main__")
