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
from pyxu_tpu_torch.models import sparse_view_ct
import pyxu_tpu_torch.operator.func.indicator, pyxu_tpu_torch.operator.linop.xray
from pyxu_tpu_torch.opt.solver import (PD3O, ChambollePock, DavisYin,
    DouglasRachford, ForwardBackward, LorisVerhoeven, ProximalPoint)
for method in ("fourier", "interp"):
    slv, fit, ex = sparse_view_ct((16, 16), n_angles=6, method=method,
                                  device="cpu", stop_rate=5)
    slv.fit(stop_crit=MaxIter(10), max_iter=10, **fit)
    assert isinstance(slv, PD3O) and bool(slv.solution().isfinite().all())
import tempfile, time
import numpy as np, torch
from pyxu_tpu_torch.abc import Mode
from pyxu_tpu_torch.math.linesearch import backtracking_linesearch
from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
from pyxu_tpu_torch.opt.solver import NLCG, PGD, ProxAdam
from pyxu_tpu_torch.opt.stop import (ManualStop, MaxCarbon, MaxDuration,
    Memorize)
y = torch.from_numpy(np.linspace(-1, 1, 8, dtype=np.float32))
f, g = 0.5 * SquaredL2Norm((8,)).asloss(y), 0.1 * L1Norm((8,))
for slv in (NLCG(f), ProxAdam(f, g)):
    slv.fit(x0=torch.zeros(8), stop_crit=MaxIter(5) | Memorize("x"),
            max_iter=5)
    assert bool(slv.solution().isfinite().all())
with tempfile.TemporaryDirectory() as d:
    slv = PGD(f, g, folder=d, exist_ok=True, writeback_rate=5,
              checkpoint_backend="torch")
    slv.fit(x0=torch.zeros(8), stop_crit=MaxIter(10), max_iter=10,
            precision_schedule=[(torch.bfloat16, 5), (torch.float32, None)])
    assert PGD.read_checkpoint(d)[0]["x"].dtype == torch.float32
slv = PGD(f, g)
for _ in slv.fit(x0=torch.zeros(8), stop_crit=MaxIter(3), max_iter=3,
                 mode=Mode.MANUAL):
    pass
slv.fit(x0=torch.zeros(8), stop_crit=ManualStop() | MaxDuration(60.0)
        | MaxCarbon(1.0, watts=700.0), max_iter=10 ** 6, segment_size=10,
        mode=Mode.ASYNC)
time.sleep(0.05)
slv.stop()
assert not slv.busy()
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
        sparse_view_ct,
        tv_deconvolution,
    )
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.operator.linop.xray import FourierRadon, RadonTransform
    from pyxu_tpu_torch.convert import nufft3_problem
    from pyxu_tpu_torch.opt.solver import (
        ADMM,
        CG,
        NLCG,
        PD3O,
        PGD,
        CondatVu,
        ProxAdam,
    )
    from pyxu_tpu_torch.operator.func import SquaredL2Norm
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
    for method in ("fourier", "interp"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sparse_view_ct((32, 32), method=method)
    for op in (FourierRadon, RadonTransform):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            op((8, 8), [0.0, 1.0])
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
    slv, fit, _ = sparse_view_ct((16, 16), n_angles=6, device="cpu")
    assert isinstance(slv, PD3O) and fit["x0"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(x0=fit["x0"].numpy(), max_iter=1)
    slv, fit = nufft3_problem(np.zeros((10, 3)), np.zeros((10, 2)),
                              (4, 4, 4), 0.5, device="cpu")
    assert isinstance(slv, CG) and fit["b"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(b=fit["b"].numpy(), max_iter=1)
    f = SquaredL2Norm((4,))
    for slv in (NLCG(f), ProxAdam(f)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            slv.fit(x0=np.zeros(4, np.float32), max_iter=1)


def test_tf32_off():
    import pyxu_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
