"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU unasked."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
import torch
torch.set_num_threads(1)     # the suite's workers share the machine's cores
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
from pyxu_tpu_torch.operator.linop import FFT
from pyxu_tpu_torch.operator.linop.nufft import NUFFT
rng = np.random.default_rng(0)
x3, z3 = rng.uniform(-1, 1, (40, 3)), rng.uniform(-5, 5, (30, 3))
for kw in ({}, {"chunked": True, "fft_mem_mb": 0.05}):
    A = NUFFT.type3(x3, z3, device="cpu", **kw)
    out = A.adjoint(A.apply(torch.ones(40, 2)))
    assert out.shape == (40, 2) and bool(out.isfinite().all())
A = NUFFT.type1(rng.uniform(-3, 3, 20), 8, device="cpu")
assert A.kernel_path == "plain" and A.apply(torch.ones(20, 2)).shape == (8, 2)
assert FFT((4, 6), real=True).apply(torch.ones(4, 6)).shape == (4, 6, 2)
from pyxu_tpu_torch.sampler import MYULA, OnlineMoment, OnlineStd
_, _, ex = lasso_deconvolution((32, 32), device="cpu")
K, y = ex["K"], ex["y"]
f = (0.5 / 0.01 ** 2) * SquaredL2Norm((32, 32)).asloss(y) * K
chain = MYULA(f, (0.05 / 0.01 ** 2) * L1Norm((32, 32))).samples(
    torch.zeros(32, 32), seed=0)
mean, std = OnlineMoment(1), OnlineStd()
for _ in range(20):
    x = next(chain)
    mean.update(x)
    std.update(x)
assert bool(mean.stat().isfinite().all()) and bool((std.stat() > 0).all())
xs = K.pinv(y, damp=1e-2)
assert torch.equal(K.dagger(1e-2).apply(y), xs)
import math
import scipy.sparse as sp
import pyxu_tpu_torch.info, pyxu_tpu_torch.utils
import pyxu_tpu_torch.operator as O
import pyxu_tpu_torch.operator.blocks, pyxu_tpu_torch.operator.linop.diff
import pyxu_tpu_torch.operator.linop.kron, pyxu_tpu_torch.operator.linop.reduce
import pyxu_tpu_torch.operator.linop.select, pyxu_tpu_torch.operator.map.ufunc
import pyxu_tpu_torch.operator.interop.sciop, pyxu_tpu_torch.operator.interop.torch
from pyxu_tpu_torch.operator.interop import from_sciop, from_torch
from pyxu_tpu_torch.opt.solver import CondatVu
L = O.vstack([O.Hessian((32, 32), directions=(0, 0), mode="symmetric"),
              math.sqrt(2) * O.Hessian((32, 32), directions=(0, 1),
                                       mode="symmetric"),
              O.Hessian((32, 32), directions=(1, 1), mode="symmetric")])
y32 = K.apply(torch.rand(32, 32))
slv = CondatVu(f=0.5 * SquaredL2Norm((32, 32)).asloss(y32) * K,
               g=O.PositiveOrthant((32, 32)),
               h=2e-3 * O.L21Norm((3, 32, 32), l2_axis=0), K=L, stop_rate=5)
slv.fit(x0=y32, stop_crit=MaxIter(10), max_iter=10)
assert slv.fused_path is None and bool(slv.solution().isfinite().all())
ops = [O.block_diag([K, K]), O.SubSample((32, 32), slice(None, None, 2)),
       O.Trim((32, 32), 2), O.Sum((32, 32), 0), O.Jacobian((2, 32, 32)),
       O.Divergence((2, 32, 32)), O.Laplacian((32, 32)),
       O.DirectionalHessian((32, 32), [(1, 0), (1, 1)], device="cpu"),
       O.Sobel((32, 32)), O.StructureTensor((32, 32)),
       O.Gradient((32, 32), diff_method="gd"),
       O.SparseExplicitLinOp(sp.eye(1024, format="csr"), dim_shape=(32, 32),
                             codim_shape=(32, 32), device="cpu"),
       O.sigmoid(K)]
for op in ops:
    assert bool(op.apply(torch.rand((2,) + op.dim_shape)).isfinite().all())
import scipy.sparse.linalg as spl
A = O.kron(O.ExplicitLinOp(torch.eye(3)),
           from_sciop(spl.aslinearoperator(sp.eye(4).tocsr())))
assert A.apply(torch.ones(12)).shape == (12,)
from pyxu_tpu_torch.abc import DiffFunc
F = from_torch(DiffFunc, (4,), apply=lambda t: (t ** 2).sum(-1))
assert torch.equal(F.grad(torch.ones(4)), 2 * torch.ones(4))
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
    for chunked in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NUFFT.type3(np.zeros((10, 2)), np.zeros((5, 2)), chunked=chunked)
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
    from pyxu_tpu_torch.abc import LinOp
    from pyxu_tpu_torch.sampler import MYULA, ULA
    for smp in (ULA(f), MYULA(f)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(smp.samples(np.zeros(4, np.float32)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smp.run(np.zeros(4, np.float32), n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinOp.from_array(np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f.argscale(2.0).jacobian(np.zeros(4, np.float32)).asarray()
    # the slice's constructors that take a host array
    import scipy.sparse as sp
    from pyxu_tpu_torch.operator.linop import (DirectionalGradient,
                                               SparseExplicitLinOp)
    from pyxu_tpu_torch.utils import star_like_sample
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DirectionalGradient((8, 8), [(1.0, 0.0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseExplicitLinOp(sp.eye(4, format="csr"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinOp.from_array(sp.eye(4, format="csr"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        star_like_sample(8, 5, 20.0, 2, 0.7)


def test_tf32_off():
    import pyxu_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_IMPORT_ALL = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyxu_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import importlib, pathlib, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
root = pathlib.Path("pyxu_tpu_torch")
names = sorted(".".join(p.with_suffix("").parts).replace(".__init__", "")
               for p in root.rglob("*.py"))
for name in names:
    importlib.import_module(name)
# the parallel layer at world size 1 on a file:// store
import torch.distributed as dist
import pyxu_tpu_torch.parallel as par
from pyxu_tpu_torch.models import consensus_tiles
from pyxu_tpu_torch.opt.stop import MaxIter
store = pathlib.Path(tempfile.mkdtemp()) / "store"
assert par.init_distributed(f"file://{store}", 1, 0, device="cpu") == 1
mesh = par.auto_mesh(device="cpu")
op = par.ShardedStencil((16, 12), [np.ones(3), np.ones(5)], [1, 2], mesh,
                        mode="wrap")
assert op.apply(torch.ones(16, 12)).full_tensor().eq(15).all()
slv, fit, _ = consensus_tiles(tile=(8, 6), n_tiles=2, device="cpu")
slv.fit(stop_crit=MaxIter(5), max_iter=5, **fit)
assert bool(slv.solution().isfinite().all())
dist.destroy_process_group()
s = par.StreamedCondatVu(np.ones((20, 9), np.float32), np.ones(3) / 3,
                         block_rows=8, device="cpu")
assert np.isfinite(s.fit(2).solution()).all()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pyxu_tpu")]
assert not bad, bad
print(len(names), "ok")
"""


def test_every_module_imports_with_jax_blocked():
    """Each module of the port, the parallel layer and the utilities
    included, imports in a child where ``jax`` and ``pyxu_tpu`` cannot be
    imported; the parallel layer runs there at world size 1."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-2])
    assert n == len(sorted((ROOT / "pyxu_tpu_torch").rglob("*.py")))


def test_parallel_entry_points_raise_without_gpu(monkeypatch):
    import pyxu_tpu_torch.parallel as par
    from pyxu_tpu_torch.models import consensus_tiles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        consensus_tiles((8, 6), n_tiles=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.StreamedCondatVu(np.ones((8, 8), np.float32), np.ones(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.streamed_map_overlap(lambda b: b, np.ones((8, 8)), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.streamed_block_diag([], [])
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.init_distributed("file:///nonexistent/store", 1, 0)
