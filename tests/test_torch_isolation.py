"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU unasked."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "pyxu_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_SOLVE = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyxu_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
from pyxu_tpu_torch.models import tv_deconvolution
from pyxu_tpu_torch.opt.stop import MaxIter
slv, fit, _ = tv_deconvolution((32, 32), device="cpu", stop_rate=5)
slv.fit(stop_crit=MaxIter(10), max_iter=10, **fit)
x = slv.solution()
assert x.shape == (32, 32) and bool(x.isfinite().all())
from pyxu_tpu_torch.models import lasso_deconvolution
import pyxu_tpu_torch.math.linalg, pyxu_tpu_torch.operator.linop.filter
slv, fit, _ = lasso_deconvolution((32, 32), device="cpu", stop_rate=5)
slv.fit(stop_crit=MaxIter(10), max_iter=10, **fit)
assert bool(slv.solution().isfinite().all())
from pyxu_tpu_torch.models import radio_interferometry
import pyxu_tpu_torch.convert, pyxu_tpu_torch.math.cg, pyxu_tpu_torch.ops.nufft
for real_sky in (True, False):
    slv, fit, ex = radio_interferometry((24, 20), n_vis=300, device="cpu",
                                        real_sky=real_sky, stop_rate=5)
    slv.fit(stop_crit=MaxIter(10), max_iter=10, **fit)
    assert bool(slv.solution().isfinite().all())
    assert ex["A"].kernel_path == "kernel"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pyxu_tpu")]
assert not bad, bad
print("ok")
"""


def test_solve_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _SOLVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "pyxu_tpu"), \
                f"{path.name} imports {n}"


def test_no_device_and_no_gpu_raises(monkeypatch):
    from pyxu_tpu_torch.models import (
        lasso_deconvolution,
        radio_interferometry,
        tv_deconvolution,
    )
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.convert import nufft3_problem
    from pyxu_tpu_torch.opt.solver import ADMM, CG, PGD, CondatVu
    from pyxu_tpu_torch.runtime import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv_deconvolution((32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lasso_deconvolution((32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        radio_interferometry((32, 32), n_vis=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NUFFT.type2(np.zeros((10, 2)), (8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    # a host array without a device does not go to the CPU either
    slv, fit, _ = tv_deconvolution((32, 32), device="cpu")
    assert isinstance(slv, CondatVu) and fit["x0"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(x0=fit["x0"].numpy(), max_iter=1)
    slv, fit, _ = lasso_deconvolution((32, 32), device="cpu")
    assert isinstance(slv, PGD) and fit["x0"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(x0=fit["x0"].numpy(), max_iter=1)
    slv, fit, _ = radio_interferometry((16, 16), n_vis=50, device="cpu")
    assert isinstance(slv, ADMM) and fit["x0"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(x0=fit["x0"].numpy(), tau=0.05, max_iter=1)
    slv, fit = nufft3_problem(np.zeros((10, 3)), np.zeros((10, 2)),
                              (4, 4, 4), 0.5, device="cpu")
    assert isinstance(slv, CG) and fit["b"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(b=fit["b"].numpy(), max_iter=1)


def test_tf32_off():
    import pyxu_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
