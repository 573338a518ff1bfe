"""The port's parallel layer against pyxu_tpu's, on the CPU.

One numpy input goes through the JAX package on the virtual CPU mesh of n
devices that ``conftest.py`` gives, and through the port on n processes
joined by gloo.  World size 1 runs in this process (a gloo group on a
``file://`` store, torn down after the module).  The multi-rank cases (n =
2 and 4) run in one launch of 4 ranks: each rank is a fresh interpreter
that imports neither ``jax`` nor ``pyxu_tpu`` (both are blocked), builds a
1-D mesh of 4 and a 2x2 mesh whose axis "s" has 2 ranks, and writes its
results to a file; the tests here compare them with the JAX results.

Tolerance: ``atol_for`` times the output's largest magnitude (at least 1):
a sum over ranks changes the order of the spreads' and the mean's sums.
The kernel launches of these paths are ``cuda`` tests in
``test_torch_kernels.py``.
"""

import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import atol_for
from _torch_mesh import mesh1  # noqa: F401  (the fixture)
from torch.distributed.tensor import DTensor, Replicate, Shard

import pyxu_tpu.parallel as jpar
from pyxu_tpu.models.workloads import consensus_tiles as jtiles
from pyxu_tpu.operator.func import L1Norm as JL1, SquaredL2Norm as JSQ
from pyxu_tpu.operator.linop import ExplicitLinOp as JExplicit
from pyxu_tpu.operator.linop import Gradient as JGradient
from pyxu_tpu.operator.linop import Sum as JSum
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
import pyxu_tpu_torch.parallel as tpar
from pyxu_tpu_torch.abc.operator import Property
from pyxu_tpu_torch.models import consensus_tiles
from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
from pyxu_tpu_torch.operator.linop import Gradient
from pyxu_tpu_torch.opt.stop import MaxIter

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TOL = atol_for(np.float32)
ITERS = 60          # ConsensusADMM parity iterations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(1414)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {
        "halo_x": f32(16, 5),
        "st_x": f32(32, 8), "st_y": f32(32, 8),
        "st_k0": np.array([1.0, -2.0, 0.5], np.float32),
        "st_k1": np.array([0.1, 0.6, 0.2, 0.1], np.float32),
        "lap": np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32),
        "ws_x": f32(32, 16), "ws_y": f32(2, 32, 16),
        "bd_mats": f32(8, 4, 4), "bd_x": f32(8, 4), "bd_y": f32(8, 4),
        "bd_x3": f32(8, 4, 3),
        "cons_y": f32(8, 6), "cons_y1": f32(8, 6) + 1.0,
        "nu_x": rng.uniform(-np.pi, np.pi, (301, 2)), "nu_a": f32(301, 2),
        "nu_f": f32(12, 10, 2),
        "nu3_x": rng.uniform(-np.pi, np.pi, (200, 3)), "nu3_a": f32(200, 2),
        "nu3_f": f32(6, 8, 5, 2),
        "t3_x": rng.uniform(-1.5, 1.5, (160, 2)),
        "t3_z": rng.uniform(-20, 20, (140, 2)), "t3_a": f32(160, 2),
        "t3_f": f32(140, 2),
        "t3s_x": rng.uniform(-1, 1, (3, 2)), "t3s_z": rng.uniform(-9, 9, (30, 2)),
        "t3s_a": f32(3, 2), "t3s_f": f32(30, 2),
    }


INPUTS = _inputs()
MODES = ("constant", "wrap")
# (kernel set, ranks on the axis, mode, sharded axis)
STENCILS = [(k, n, m, 0) for k in ("axis0", "sep", "lap") for n in (1, 2, 4)
            for m in MODES] + [("sep", n, m, 1) for n in (1, 2) for m in MODES]


def _stencil_args(name, I):
    """(kernel, center) of a kernel set, as numpy arrays."""
    k0, k1 = I["st_k0"], I["st_k1"]
    return {"axis0": (k0.reshape(3, 1), (1, 0)), "sep": ([k0, k1], [1, 2]),
            "lap": (I["lap"], (1, 1))}[name]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_auto_mesh_without_group_raises():
    """Runs first in the module, before any group is up in this process."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        tpar.auto_mesh(device="cpu")


# ------------------------------------------------------- the 4-rank launch --

_RANKS = r'''
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyxu_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import datetime
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import pyxu_tpu_torch.parallel as tpar
from pyxu_tpu_torch.models import consensus_tiles
from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
from pyxu_tpu_torch.operator.linop import ExplicitLinOp, Gradient, Sum
from pyxu_tpu_torch.opt.stop import MaxIter, RelError

rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
assert tpar.init_distributed("file://" + store, world, rank, device="cpu",
                             timeout=datetime.timedelta(seconds=120)) == world
I = dict(np.load(inp))
STENCILS = %(stencils)r
ITERS = %(iters)d
R = {}
meshes = {4: tpar.auto_mesh(device="cpu"),
          2: tpar.auto_mesh(2, 2, axis_names=("dp", "s"), device="cpu")}
R["mesh_shape"] = np.array(meshes[2].mesh.shape)
R["mesh_names"] = np.array(meshes[2].mesh_dim_names)
R["mesh_ax0"] = np.array(tpar.auto_mesh(4, axis_names=("ax0",),
                                        device="cpu").mesh_dim_names)

def full(t):
    assert isinstance(t, torch.distributed.tensor.DTensor), type(t)
    return t.full_tensor().numpy()

def error(fn):
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return ""

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))

%(stencil_args)s

for n, mesh in meshes.items():
    ax = "s"
    for mode in ("constant", "wrap"):
        loc = tpar.shard(I["halo_x"], mesh, tpar.P(ax)).to_local()
        R[f"halo_{mode}_{n}"] = tpar.halo_exchange(
            loc, 2, 1, 0, mesh, mode, mesh_axis=ax).numpy()
    for name, nn, mode, sa in STENCILS:
        if nn != n:
            continue
        k, c = _stencil_args(name, I)
        op = tpar.ShardedStencil((32, 8), k, c, mesh, shard_axis=sa,
                                 mesh_axis=ax, mode=mode)
        spec = (ax, None) if sa == 0 else (None, ax)
        key = f"st_{name}_{n}_{mode}_{sa}"
        R[key + "_apply"] = full(op.apply(tpar.shard(I["st_x"], mesh, spec)))
        R[key + "_adjoint"] = full(op.adjoint(t(I["st_y"])))
        R[key + "_path"] = np.array(str(op.kernel_path))
    fs = [SquaredL2Norm((6,)).asloss(t(y)) for y in I["cons_y"]]
    slv = tpar.ConsensusADMM(fs, mesh=mesh, mesh_axis=ax)
    slv.fit(z0=torch.zeros(6), stop_crit=MaxIter(ITERS), max_iter=ITERS)
    R[f"cons_mean_{n}"] = slv.solution().numpy()
    R[f"cons_mean_obj_{n}"] = slv.objective_func(slv._mstate).numpy()
    fs = [SquaredL2Norm((6,)).asloss(t(y)) for y in I["cons_y1"]]
    slv = tpar.ConsensusADMM(fs, g=(8 * 0.5) * L1Norm((6,)), mesh=mesh,
                             mesh_axis=ax)
    slv.fit(z0=torch.zeros(6), stop_crit=MaxIter(ITERS), max_iter=ITERS)
    R[f"cons_g_{n}"] = slv.solution().numpy()
    R[f"cons_g_obj_{n}"] = slv.objective_func(slv._mstate).numpy()
    # the default criterion (RelError on z, flag reduced over the ranks)
    slv.fit(z0=torch.zeros(6), max_iter=2000)
    R[f"cons_default_iters_{n}"] = np.array(slv._last_k)
    # ShardedNUFFT, types 1 and 2 (M = 301 does not divide)
    sh = tpar.ShardedNUFFT(I["nu_x"], (12, 10), mesh, axis=ax,
                           dtype=torch.float32, device="cpu")
    R[f"nu_apply_{n}"] = full(sh.apply(t(I["nu_a"])))
    R[f"nu_adjoint_{n}"] = full(sh.adjoint(t(I["nu_f"])))

m = meshes[4]
D = Gradient((32, 16), mode="symmetric")
Ds = tpar.with_sharding(D, m, in_spec=("s", None), out_spec=(None, "s", None))
y = Ds.apply(t(I["ws_x"]))
R["ws_apply"] = full(y)
R["ws_apply_placement"] = np.array(str(y.placements))
R["ws_adjoint"] = full(Ds.adjoint(y))
ops = [ExplicitLinOp(t(a)) for a in I["bd_mats"]]
op = tpar.sharded_block_diag(ops, m)
R["bd_apply"] = full(op.apply(tpar.shard(I["bd_x"], m, tpar.P("s"))))
R["bd_adjoint"] = full(op.adjoint(t(I["bd_y"])))
R["bd_sum"] = full(tpar.sharded_block_diag(
    [Sum((4, 3), axis=-1) for _ in range(8)], m).apply(t(I["bd_x3"])))
fop = tpar.sharded_block_diag([SquaredL2Norm((4,)) for _ in range(8)], m)
R["bd_func"] = full(fop.apply(t(I["bd_x"])))
R["bd_prox"] = full(fop.prox(t(I["bd_x"]), 0.5))
slv, fit, _ = consensus_tiles(tile=(64, 48), n_tiles=8, device="cpu")
slv.fit(stop_crit=MaxIter(30), max_iter=30, **fit)
R["tiles"] = slv.solution().numpy()
sh = tpar.ShardedNUFFT(I["nu3_x"], (6, 8, 5), m, dtype=torch.float32,
                       device="cpu")
R["nu3_apply"] = full(sh.apply(t(I["nu3_a"])))
R["nu3_adjoint"] = full(sh.adjoint(t(I["nu3_f"])))
op = tpar.ShardedNUFFT3(I["t3_x"], I["t3_z"], m, fft_mem_mb=1e-3,
                        dtype=torch.float32, device="cpu")
R["t3_stats"] = np.array(str(op.stats()))
R["t3_apply"] = full(op.apply(t(I["t3_a"])))
R["t3_adjoint"] = full(op.adjoint(t(I["t3_f"])))
op = tpar.ShardedNUFFT3(I["t3s_x"], I["t3s_z"], m, dtype=torch.float32,
                        device="cpu")
R["t3s_apply"] = full(op.apply(t(I["t3s_a"])))
R["t3s_adjoint"] = full(op.adjoint(t(I["t3s_f"])))
# rejections
R["err_mode"] = np.array(error(lambda: tpar.halo_exchange(
    torch.ones(4, 3), 1, 1, 0, m, mode="reflect")))
R["err_wide"] = np.array(error(lambda: tpar.ShardedStencil(
    (8, 4), np.ones((7, 1), np.float32), (3, 0), m)))
R["err_wide_exchange"] = np.array(error(lambda: tpar.halo_exchange(
    torch.ones(2, 3), 3, 0, 0, m)))
R["err_blocks"] = np.array(error(lambda: tpar.ConsensusADMM(
    [SquaredL2Norm((4,)).asloss(torch.ones(4)) for _ in range(6)], mesh=m)))
np.savez(out, **R)
dist.barrier()
dist.destroy_process_group()
print("ok")
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 ranks once; each rank's results, by rank."""
    d = tmp_path_factory.mktemp("gloo")
    np.savez(d / "in.npz", **INPUTS)
    code = _RANKS % {"stencils": STENCILS, "iters": ITERS,
                     "stencil_args": inspect.getsource(_stencil_args)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), str(d / "store"),
         str(d / "in.npz"), str(d / f"out{r}.npz")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and so.strip().endswith("ok"), \
            f"rank {r}: {se[-4000:]}"
    return [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]


# ----------------------------------------------------- the in-process rank --

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _full(t):
    assert isinstance(t, DTensor), type(t)
    return t.full_tensor().numpy()


# ------------------------------------------------------- the JAX side --

def _jmesh(n):
    return jpar.auto_mesh(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's results on the virtual mesh, each group of calls
    under one ``jax.jit`` (a compile each; eager calls compile op by op).
    Results that do not depend on n (the operators, the solves) are taken
    on the 4-device mesh."""
    I = {k: jnp.asarray(v) for k, v in INPUTS.items()}
    R = {}
    for n in (1, 2, 4):
        m = _jmesh(n)
        halo = [jax.shard_map(
            lambda b, mode=mode: jpar.halo_exchange(b, 2, 1, 0, "s", mode),
            mesh=m, in_specs=jpar.P("s"), out_specs=jpar.P("s"))
            for mode in MODES]
        ops = {}
        for case in STENCILS:
            name, nn, mode, sa = case
            if nn == n:
                k, c = _stencil_args(name, INPUTS)
                k = [jnp.asarray(a) for a in k] if isinstance(k, list) \
                    else jnp.asarray(k)
                ops[case] = jpar.ShardedStencil((32, 8), k, c, m,
                                                shard_axis=sa, mode=mode)

        def run(x, y, halo=halo, ops=ops):
            return ([f(I["halo_x"]) for f in halo],
                    {c: (o.apply(x), o.adjoint(y)) for c, o in ops.items()})
        hs, st = jax.jit(run)(I["st_x"], I["st_y"])
        for mode, h in zip(MODES, hs):
            R["halo", n, mode] = np.asarray(h)
        for case, (a, b) in st.items():
            R["st", case] = (np.asarray(a), np.asarray(b))
    m4 = _jmesh(4)
    D = JGradient((32, 16), mode="symmetric")
    Ds = jpar.with_sharding(D, m4, in_spec=("s", None),
                            out_spec=(None, "s", None))
    bd = jpar.sharded_block_diag([JExplicit(a) for a in I["bd_mats"]], m4)
    bs = jpar.sharded_block_diag([JSum((4, 3), axis=-1) for _ in range(8)],
                                 m4)
    bf = jpar.sharded_block_diag([JSQ((4,)) for _ in range(8)], m4)
    nu = jpar.ShardedNUFFT(INPUTS["nu_x"], (12, 10), m4)
    nu3 = jpar.ShardedNUFFT(INPUTS["nu3_x"], (6, 8, 5), m4)
    t3 = {n: jpar.ShardedNUFFT3(INPUTS["t3_x"], INPUTS["t3_z"], _jmesh(n),
                                fft_mem_mb=1e-3) for n in (1, 4)}
    t3s = jpar.ShardedNUFFT3(INPUTS["t3s_x"], INPUTS["t3s_z"], m4)

    def ops_run():
        return {"ws_apply": Ds.apply(I["ws_x"]),
                "bd_apply": bd.apply(I["bd_x"]),
                "bd_adjoint": bd.adjoint(I["bd_y"]),
                "bd_sum": bs.apply(I["bd_x3"]),
                "bd_func": bf.apply(I["bd_x"]),
                "bd_prox": bf.prox(I["bd_x"], 0.5),
                "nu_apply": nu.apply(I["nu_a"]),
                "nu_adjoint": nu.adjoint(I["nu_f"]),
                "nu3_apply": nu3.apply(I["nu3_a"]),
                "nu3_adjoint": nu3.adjoint(I["nu3_f"]),
                "t3s_apply": t3s.apply(I["t3s_a"]),
                "t3s_adjoint": t3s.adjoint(I["t3s_f"])}
    R.update({k: np.asarray(v) for k, v in jax.jit(ops_run)().items()})
    # the unwrapped adjoint, on an unsharded input: the JAX package's
    # sharded adjoint of this Gradient (and its plain adjoint fed the
    # sharded output inside one jit) differ from it on the 4-device CPU
    # mesh, by ~10 on these inputs; the port's equals it
    R["ws_adjoint"] = np.asarray(jax.jit(D.adjoint)(R["ws_apply"]))
    for n, op in t3.items():        # one mesh a jit
        a, b = jax.jit(lambda op=op: (op.apply(I["t3_a"]),
                                      op.adjoint(I["t3_f"])))()
        R[f"t3_apply_{n}"], R[f"t3_adjoint_{n}"] = np.asarray(a), np.asarray(b)
    R["t3_stats"] = {n: str(op.stats()) for n, op in t3.items()}
    for key, g in (("cons_y", None), ("cons_y1", (8 * 0.5) * JL1((6,)))):
        fs = [JSQ((6,)).asloss(y) for y in I[key]]
        slv = jpar.ConsensusADMM(fs, g=g, mesh=m4)
        slv.fit(z0=jnp.zeros(6, jnp.float32), stop_crit=JMaxIter(ITERS),
                max_iter=ITERS)
        R[key] = np.asarray(slv.solution())
        R[key + "_obj"] = np.asarray(slv.objective_func(slv._mstate))
    slv, kw, ex = jtiles(tile=(64, 48), n_tiles=8, mesh=m4)
    slv.fit(stop_crit=JMaxIter(30), max_iter=30, **kw)
    R["tiles"] = np.asarray(slv.solution())
    R["tiles_y3"] = np.asarray(ex["ys"][3])
    return R


# ------------------------------------------------------------------- mesh --

def test_mesh_and_placements(mesh1, ranks):
    assert tpar.init_distributed() == 1            # idempotent
    assert mesh1.mesh_dim_names == ("s",) and mesh1.size() == 1
    x = INPUTS["st_x"]
    xs = tpar.shard(x, mesh1, tpar.P("s", None))
    assert xs.placements == (Shard(0),)
    assert tpar.replicate(x, mesh1).placements == (Replicate(),)
    np.testing.assert_array_equal(_full(xs), x)
    assert tuple(ranks[0]["mesh_shape"]) == (2, 2)
    assert tuple(ranks[0]["mesh_names"]) == ("dp", "s")
    assert tuple(ranks[0]["mesh_ax0"]) == ("ax0",)


# ------------------------------------------------------------------- halo --

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_exchange(n, mode, mesh1, ranks, jref):
    if n == 1:
        loc = tpar.shard(INPUTS["halo_x"], mesh1, tpar.P("s")).to_local()
        got = tpar.halo_exchange(loc, 2, 1, 0, mesh1, mode).numpy()
    else:   # the ranks of axis "s": 0-3 on the 1-D mesh, 0-1 on the 2x2
        got = np.concatenate([ranks[r][f"halo_{mode}_{n}"]
                              for r in range(n)])
    np.testing.assert_array_equal(got, jref["halo", n, mode])


# ------------------------------------------------------------ stencil --

@pytest.mark.parametrize("case", STENCILS, ids=lambda c: "-".join(map(str, c)))
def test_sharded_stencil(case, mesh1, ranks, jref):
    name, n, mode, sa = case
    if n == 1:
        k, c = _stencil_args(name, INPUTS)
        op = tpar.ShardedStencil((32, 8), k, c, mesh1, shard_axis=sa,
                                 mode=mode)
        got_a = _full(op.apply(_t(INPUTS["st_x"])))
        got_b = _full(op.adjoint(_t(INPUTS["st_y"])))
        path = op.kernel_path
    else:
        key = f"st_{name}_{n}_{mode}_{sa}"
        got_a, got_b = ranks[0][key + "_apply"], ranks[0][key + "_adjoint"]
        assert all(np.array_equal(ranks[r][key + "_apply"], got_a)
                   for r in range(WORLD))
        path = str(ranks[0][key + "_path"])
    assert str(path) == ("kernel" if name == "sep" else "None")
    want_a, want_b = jref["st", case]
    _close(got_a, want_a)
    _close(got_b, want_b)


# ------------------------------------------------- sharding wrappers --

def test_with_sharding_matches(ranks, jref):
    _close(ranks[0]["ws_apply"], jref["ws_apply"])
    _close(ranks[0]["ws_adjoint"], jref["ws_adjoint"])
    assert str(ranks[0]["ws_apply_placement"]) == str((Shard(dim=1),))


def test_with_sharding_preserves_properties(mesh1):
    w = tpar.with_sharding(SquaredL2Norm((8,)), mesh1, in_spec=("s",))
    assert not w.has(Property.LINEAR)
    assert w.has(Property.PROXIMABLE) and w.has(Property.DIFFERENTIABLE)
    assert w.lipschitz == SquaredL2Norm((8,)).lipschitz
    x = np.tile(INPUTS["bd_x"][0], 2)
    _close(_full(w.grad(_t(x))), 2 * x)
    _close(_full(w.prox(_t(x), 0.5)), x / 2)
    assert type(tpar.with_sharding(SquaredL2Norm((8,)), mesh1, ("s",))) \
        is type(w)                                  # the per-class cache
    D = Gradient((32, 16), mode="symmetric")
    Ds = tpar.with_sharding(D, mesh1, ("s", None), (None, "s", None))
    assert Ds.has(Property.LINEAR) and Ds.lipschitz == D.lipschitz
    assert "sharded[" in Ds.expr()
    _close(_full(Ds.apply(_t(INPUTS["ws_x"]))),
           D.apply(_t(INPUTS["ws_x"])).numpy())


@pytest.mark.parametrize("what", ["apply", "adjoint", "sum", "func", "prox"])
def test_sharded_block_diag(what, ranks, jref):
    _close(ranks[0]["bd_" + what], jref["bd_" + what])


# ------------------------------------------------------------- consensus --

@pytest.mark.parametrize("with_g", [False, True], ids=["mean", "l1"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_consensus_admm(n, with_g, mesh1, ranks, jref):
    key = "cons_y1" if with_g else "cons_y"
    if n == 1:
        fs = [SquaredL2Norm((6,)).asloss(_t(y)) for y in INPUTS[key]]
        g = (8 * 0.5) * L1Norm((6,)) if with_g else None
        got = {}
        for m in (None, mesh1):     # the single-process solver, a mesh of 1
            slv = tpar.ConsensusADMM(fs, g=g, mesh=m)
            slv.fit(z0=torch.zeros(6), stop_crit=MaxIter(ITERS),
                    max_iter=ITERS)
            got[m is None] = slv.solution().numpy()
        np.testing.assert_array_equal(got[True], got[False])
        got = got[True]
        obj = slv.objective_func(slv._mstate).numpy()
    else:
        tag = "g" if with_g else "mean"
        got = ranks[0][f"cons_{tag}_{n}"]
        for r in range(WORLD):      # z is replicated
            np.testing.assert_array_equal(ranks[r][f"cons_{tag}_{n}"], got)
        obj = ranks[0][f"cons_{tag}_obj_{n}"]
    _close(got, jref[key])
    _close(obj, jref[key + "_obj"])
    if with_g:      # the soft-thresholded mean, min of the consensus LASSO
        ybar = INPUTS["cons_y1"].mean(0)
        want = np.sign(ybar) * np.maximum(np.abs(ybar) - 0.25, 0)
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_consensus_default_stop_is_shared(ranks):
    """RelError on z, its flag reduced by MAX: every rank stops at one
    iteration, and the run ends (no rank waits in an all-reduce)."""
    for n in (2, 4):
        its = {int(ranks[r][f"cons_default_iters_{n}"]) for r in range(WORLD)}
        assert len(its) == 1 and 0 < its.pop() < 2000


def test_consensus_tiles_64x48(mesh1, ranks, jref):
    _close(ranks[0]["tiles"], jref["tiles"])
    slv, fit, ex = consensus_tiles(tile=(64, 48), n_tiles=8, device="cpu")
    assert slv._mesh is not None        # a group is up: auto_mesh()
    np.testing.assert_array_equal(ex["ys"][3].numpy(), jref["tiles_y3"])
    slv.fit(stop_crit=MaxIter(30), max_iter=30, **fit)
    _close(slv.solution().numpy(), jref["tiles"])


def test_consensus_validates_block_count(mesh1, ranks):
    assert "divisible" in str(ranks[0]["err_blocks"])
    with pytest.raises(ValueError, match="non-empty"):
        tpar.ConsensusADMM([], mesh=None)
    with pytest.raises(TypeError, match="list"):
        tpar.ConsensusADMM(SquaredL2Norm((4,)), mesh=None)
    with pytest.raises(ValueError, match="divisible"):
        jpar.ConsensusADMM([JSQ((4,)).asloss(jnp.ones(4))] * 6,
                           mesh=_jmesh(4))


def test_halo_rejections(mesh1, ranks):
    assert str(ranks[0]["err_mode"]).startswith("ValueError") and \
        "'constant'/'wrap'" in str(ranks[0]["err_mode"])
    assert "exceeds the local shard" in str(ranks[0]["err_wide"])
    assert "exceeds the local shard" in str(ranks[0]["err_wide_exchange"])
    with pytest.raises(ValueError, match="constant"):
        tpar.halo_exchange(torch.ones(16), 1, 1, 0, mesh1, mode="reflect")
    with pytest.raises(ValueError, match="modes"):
        tpar.ShardedStencil((8, 4), np.ones((3, 1)), (1, 0), mesh1,
                            mode="reflect")
    with pytest.raises(AssertionError, match="exceeds the local shard"):
        jpar.ShardedStencil((8, 4), jnp.ones((7, 1)), (3, 0), _jmesh(4))


# ------------------------------------------------------------------ NUFFT --

@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_nufft_2d(n, mesh1, ranks, jref):
    if n == 1:
        op = tpar.ShardedNUFFT(INPUTS["nu_x"], (12, 10), mesh1,
                               dtype=torch.float32, device="cpu")
        assert op.kernel_path == "kernel"
        ya = op.apply(_t(INPUTS["nu_a"]))
        yf = op.adjoint(_t(INPUTS["nu_f"]))
        assert ya.placements == (Replicate(),) and \
            yf.placements == (Shard(0),)
        got_a, got_f = _full(ya), _full(yf)
    else:
        got_a, got_f = ranks[0][f"nu_apply_{n}"], ranks[0][f"nu_adjoint_{n}"]
    _close(got_a, jref["nu_apply"])
    _close(got_f, jref["nu_adjoint"])


def test_sharded_nufft_3d(ranks, jref):
    _close(ranks[0]["nu3_apply"], jref["nu3_apply"])
    _close(ranks[0]["nu3_adjoint"], jref["nu3_adjoint"])


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_nufft3(n, mesh1, ranks, jref):
    if n == 1:
        op = tpar.ShardedNUFFT3(INPUTS["t3_x"], INPUTS["t3_z"], mesh1,
                                fft_mem_mb=1e-3, dtype=torch.float32,
                                device="cpu")
        stats = str(op.stats())
        got_a = _full(op.apply(_t(INPUTS["t3_a"])))
        got_f = _full(op.adjoint(_t(INPUTS["t3_f"])))
    else:
        stats = str(ranks[0]["t3_stats"])
        got_a, got_f = ranks[0]["t3_apply"], ranks[0]["t3_adjoint"]
    assert stats == jref["t3_stats"][n]
    _close(got_a, jref[f"t3_apply_{n}"])
    _close(got_f, jref[f"t3_adjoint_{n}"])


def test_sharded_nufft3_fewer_points_than_ranks(ranks, jref):
    _close(ranks[0]["t3s_apply"], jref["t3s_apply"])
    _close(ranks[0]["t3s_adjoint"], jref["t3s_adjoint"])
