"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (the other ``test_torch_*`` files take their
shared inputs from here).  On a machine with an NVIDIA GPU (``nvcc`` on the
path or under ``/usr/local/cuda``)::

    python -m pytest tests/test_torch_kernels.py --noconftest -q -m cuda

Without a GPU the ``cuda`` tests skip with a reason; the wrapper checks run
anywhere.
"""

import math

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
    # the K-step's 47x63 tile plus K levels of 2h-px aprons per side and
    # one row and column, five arrays at an odd pitch, then the rows a tap
    # strip may overrun; the single step's 31x31 tile plus one level
    assert ft.smem_bytes(p, 3) == (5 * 96 * 113 + 7 * 113 + 8) * 4
    assert ft.smem_bytes(p, 1) == (5 * 48 * 49 + 7 * 49 + 8) * 4
    assert ft.window_fits((96, 112), p, 3)
    assert not ft.window_fits((95, 112), p, 3)
    assert not ft.window_fits((96, 111), p, 3)
    assert not ft.window_fits((4000, 4000), p, 5)      # shared memory


def _interior_by_block(shape, p, n_steps):
    """tv_interior of csrc/fused_tv.cu, block by block."""
    (H, W), (tr, tc), (g0, g1) = shape, ft._tile(n_steps), p.apron
    n = 0
    for by in range(-(-H // tr)):
        for bx in range(-(-W // tc)):
            wr, wq = by * tr - n_steps * g0, bx * tc - n_steps * g1
            n += (wr >= 0 and wq >= 0 and wr + tr + 2 * n_steps * g0 + 1 <= H
                  and wq + tc + 2 * n_steps * g1 + 1 <= W)
    return n


@pytest.mark.parametrize("n_steps,want", [(1, (8296, 8680)),
                                          (2, (5440, 5740)),
                                          (3, (2596, 2806)),
                                          (4, (5280, 5740))])
def test_interior_blocks_at_4k(n_steps, want):
    """Blocks of a 2160x3840 launch with the workload's 9-tap blur whose
    window lies inside the frame (normal form), of all blocks."""
    p = _params(_gauss(), _gauss(), 4, 4, "symmetric", 1.0)
    assert ft.interior_blocks((2160, 3840), p, n_steps) == want
    assert want[0] == _interior_by_block((2160, 3840), p, n_steps)
    k0, k1, c0, c1 = ASYM
    pa = _params(k0, k1, c0, c1, "constant", 1.0)
    for shape in KERNEL_SHAPES:
        assert ft.interior_blocks(shape, pa, n_steps)[0] == \
            _interior_by_block(shape, pa, n_steps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    return torch.device("cuda")


# a shape the tiles divide into neither way, and one further off; at each
# depth both hold interior blocks (normal form) and edge blocks
KERNEL_SHAPES = [(200, 180), (263, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["gauss", "asym"])
@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("rho", [1.0, 0.9])
@pytest.mark.parametrize("zdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_kernel_matches_plain(cuda, taps, mode, rho, zdt, n_steps, shape):
    k0, k1, c0, c1 = (_gauss(), _gauss(), 4, 4) if taps == "gauss" else ASYM
    p = _params(k0, k1, c0, c1, mode, rho)
    assert ft.window_fits(shape, p, n_steps)
    inner, total = ft.interior_blocks(shape, p, n_steps)
    assert 0 < inner < total
    x, z, b = (a.to(cuda) for a in _state(*shape))
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
# a tile whose pad width equals its length, and off-centre centres; then
# images with full streaming bands and strips beside fold edge blocks: W a
# multiple of 4 (16-byte path), W % 4 != 0, and a batch whose images sit
# back to back with W odd
ST_SHAPES = [(50, 70), (64, 128), (33, 257), (4, 9), (300, 520), (257, 389),
             (3, 67, 129)]
ST_TAPS = {"3x4": (3, 4, 1, 2), "9x9": (9, 9, 4, 4), "1x5": (1, 5, 0, 1),
           "4x3off": (4, 3, 3, 0)}


def _sep(taps, mode, seed=1):
    lh, lw, ch, cw = ST_TAPS[taps]
    rng = np.random.default_rng(seed)
    return st.SepTaps(k0=tuple(rng.standard_normal(lh)), c0=ch,
                      k1=tuple(rng.standard_normal(lw)), c1=cw, mode=mode)


def _fits(shape, p):
    return p.halo[0] <= shape[-2] and p.halo[1] <= shape[-1]


def _scipy_apply(x, p):
    """Reference apply over the trailing two axes: scipy's correlate1d per
    axis (numpy 'symmetric' is scipy's 'reflect')."""
    mode = "reflect" if p.mode == "symmetric" else "constant"
    out = x
    for ax, k, c in ((-2, p.k0, p.c0), (-1, p.k1, p.c1)):
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


def _stencil_cover(shape, p, adjoint, dtype=torch.float32):
    """How often each output of one image is written by the launch of
    ``st.launch_plan``, block by block as ``st_kernel`` assigns the work:
    warp w of the streaming blocks takes band w % bands of strip w // bands
    and stores inside the frame; edge block e takes tile e of the frame's
    rectangles, in order."""
    plan = st.launch_plan(shape, p, adjoint, dtype)
    H, W = plan["shape"]
    fa, fb, fa1, fb1 = plan["frame"]
    n = np.zeros((H, W), np.int64)
    for blk in range(plan["stream_blocks"]):
        for warp in range(plan["warps"]):
            w = blk * plan["warps"] + warp
            if w >= plan["bands"] * plan["strips"]:
                continue
            s0 = (w // plan["bands"]) * plan["sr"]
            q0 = (w % plan["bands"]) * plan["band"]
            r = slice(max(s0, fa), min(s0 + plan["sr"], H, fb))
            c = slice(max(q0, fa1), min(q0 + plan["band"], W, fb1))
            n[r, c] += 1
    tr, tc = st._EDGE_TILE
    edges = 0
    for r0, r1, q0, q1 in st.edge_rects(plan):
        if r1 <= r0 or q1 <= q0:
            continue
        for i in range(r0, r1, tr):
            for j in range(q0, q1, tc):
                n[i:min(i + tr, r1), j:min(j + tc, q1)] += 1
                edges += 1
    assert edges == plan["edge_blocks"]
    return plan, n


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
def test_stencil_launch_covers_4k_once(mode, adjoint):
    """Bands and strips (and in the fold, the edge tiles) write every
    output of a 2160x3840 plane exactly once."""
    p = _sep("9x9", mode)
    plan, n = _stencil_cover((2160, 3840), p, adjoint)
    assert plan["fast"] and plan["vec"]
    assert n.min() == n.max() == 1


@pytest.mark.parametrize("taps", sorted(ST_TAPS))
def test_stencil_launch_covers_test_shapes_once(taps):
    for shape in ST_SHAPES + [(1, 1), (2153, 3833), (9, 4000)]:
        for mode in ("constant", "symmetric"):
            p = _sep(taps, mode)
            if not _fits(shape, p):
                continue
            for adjoint in (False, True):
                for dtype in (torch.float32, torch.float64):
                    _, n = _stencil_cover(shape, p, adjoint, dtype)
                    assert n.min() == n.max() == 1, (shape, mode, adjoint)


@pytest.mark.parametrize("shape,adjoint,want", [
    ((2160, 3840), False, (32, 68, 8, 255, 0)),
    ((2160, 3840), True, (32, 68, 8, 255, 256)),
    ((256, 256), False, (4, 64, 2, 64, 0)),
    ((256, 256), True, (4, 64, 2, 64, 24))])
def test_stencil_launch_blocks(shape, adjoint, want):
    """Strip rows, strips, warps a block, streaming and edge blocks of the
    workload's 9+9-tap symmetric blur, at 4K and at the 256x256 bench leg:
    30 (or 2) bands of 128 columns; 2040 streaming warps at 4K, and 128 in
    64 blocks at 256x256, where the strips shrink to 4 rows; the fold's
    edge tiles are 1 x 60 for each of the top and bottom rows and 68 x 1
    for each side column at 4K (4 + 4 + 8 + 8 at 256x256)."""
    plan = st.launch_plan(shape, _sep("9x9", "symmetric"), adjoint)
    assert plan["bands"] == -(-shape[1] // 128)
    assert (plan["sr"], plan["strips"], plan["warps"], plan["stream_blocks"],
            plan["edge_blocks"]) == want


def test_stencil_ring_fits_shared_memory():
    """A block's rings (ST_NBUF rows of the band, its rounded halo and one
    16-byte piece a warp, and for runtime tap counts L0 rows of sums) and
    the fold's edge window fit the shared memory the launch asks for, and
    that fits the card, for every tap count and centre the kernel takes."""
    gm = st._GEOM
    for dtype in (torch.float32, torch.float64):
        elem = torch.empty((), dtype=dtype).element_size()
        V = 16 // elem
        for L in range(1, st._MAX_TAPS + 1):
            for c in {0, L // 2, L - 1}:
                p = st.SepTaps((1.0,) * L, c, (1.0,) * L, L - 1 - c,
                               "symmetric")
                h0, h1 = p.halo
                H1 = -(-h1 // V) * V
                for adjoint in (False, True):
                    plan = st.launch_plan((3, 200, 300), p, adjoint, dtype)
                    assert plan["ring_row"] == plan["band"] + 2 * H1 + V
                    ring = gm["nbuf"] * plan["ring_row"] + (
                        0 if plan["fast"] else L * plan["band"])
                    edge = (32 + 2 * h0 + 32) * (64 + 2 * h1) \
                        if plan["edge_blocks"] else 0
                    assert bool(plan["edge_blocks"]) == (adjoint and L > 1)
                    assert plan["smem_bytes"] == elem * max(
                        plan["warps"] * ring, edge)
                    assert plan["smem_bytes"] <= st._MAX_SMEM
                    assert plan["warps"] >= 2


def test_stencil_test_shapes_reach_every_path():
    """The cuda tests' shapes hold full streaming bands beside the fold's
    edge blocks, the 16-byte and the scalar path, a batch, and both the
    unrolled and the runtime-tap path."""
    plans = {s: st.launch_plan(s, _sep("9x9", "symmetric"), True)
             for s in ST_SHAPES}
    assert all(p["stream_blocks"] and p["edge_blocks"]
               for p in plans.values())
    assert plans[(300, 520)]["vec"] and plans[(300, 520)]["bands"] == 5
    assert not plans[(257, 389)]["vec"] and plans[(257, 389)]["strips"] > 1
    assert plans[(3, 67, 129)]["batch"] == 3 and not plans[(3, 67, 129)]["vec"]
    assert plans[(300, 520)]["fast"]
    assert not st.launch_plan((300, 520), _sep("3x4", "symmetric"))["fast"]


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
def test_stencil_plan_matches_the_kernel(cuda):
    """The kernel's own geometry (stencil_plan) is launch_plan's."""
    lib = st._library()[0]
    for shape in ST_SHAPES + [(2160, 3840), (256, 256), (2153, 3833)]:
        for taps in sorted(ST_TAPS):
            for mode in ("constant", "symmetric"):
                p = _sep(taps, mode)
                if not _fits(shape, p):
                    continue
                for adjoint in (False, True):
                    for dtype in (torch.float32, torch.float64):
                        got = st.kernel_plan(lib, shape, p, adjoint, dtype)
                        want = st.launch_plan(shape, p, adjoint, dtype)
                        assert got == {k: want[k] for k in got}, (
                            shape, taps, mode, adjoint, dtype)


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


def _members(taps, mode, n=3):
    """n tap sets of one layout, each drawn from its own seed."""
    return st.MemberTaps([_sep(taps, mode, seed=1 + i) for i in range(n)])


def _each_member(x, mt, adjoint, shared_input=False):
    """The members' correlations one by one with the single-tap-set plain
    version."""
    outs = [st.separable_correlate2d_plain(
        x if shared_input else x[..., i, :, :], p, adjoint)
        for i, p in enumerate(mt.taps)]
    return torch.stack(outs, dim=-3)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", ["9x9", "4x3off"])
def test_stencil_members_plain_is_each_members_plain(taps, mode, adjoint):
    """Per-member taps: member i's correlation of image i (or of the shared
    input), bit for bit the single-tap-set plain version's."""
    mt = _members(taps, mode)
    rng = np.random.default_rng(2)
    for dt in (np.float32, np.float64):
        x = torch.from_numpy(rng.standard_normal((2, 3, 20, 23)).astype(dt))
        assert torch.equal(st.separable_correlate2d_members_plain(
            x, mt, adjoint), _each_member(x, mt, adjoint))
        assert torch.equal(st.separable_correlate2d_members_plain(
            x[:, 0], mt, adjoint, shared_input=True),
            _each_member(x[:, 0], mt, adjoint, shared_input=True))


def test_stencil_members_cpu_wrapper_and_checks():
    mt = _members("3x4", "symmetric")
    x = torch.from_numpy(np.random.default_rng(0).random((3, 40, 30),
                                                         np.float32))
    n0 = st.separable_correlate2d_members.launches
    for adj in (False, True):
        assert torch.equal(st.separable_correlate2d_members(x, mt, adj),
                           st.separable_correlate2d_members_plain(x, mt, adj))
    with pytest.raises(ValueError):
        st.separable_correlate2d_members(torch.zeros((3, 16, 16),
                                                     device="meta"), mt)
    assert st.separable_correlate2d_members.launches == n0
    with pytest.raises(ValueError):         # one layout for every member
        st.MemberTaps([_sep("3x4", "symmetric"), _sep("4x3off", "symmetric")])
    assert mt.n == 3 and mt.k0.shape == (3, 3) and mt.k1.shape == (3, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", ["9x9", "3x4", "4x3off"])
@pytest.mark.parametrize("shape", [(50, 70), (300, 520), (257, 389)],
                         ids=str)
def test_stencil_members_kernel_matches_plain(cuda, shape, taps, mode,
                                              adjoint, dtype):
    """One launch with a tap set a member, a block-diagonal batch (two
    groups of three members) and a shared input, against the plain
    version."""
    mt = _members(taps, mode)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3) + shape)).to(
        getattr(torch, dtype)).to(cuda)
    tol = (1e-5 if dtype == "float32" else 1e-12) * float(x.abs().max()) \
        * max(1.0, float(np.max(np.abs(mt.k0).sum(1) * np.abs(mt.k1).sum(1))))
    for xin, shared in ((x, False), (x[:, 0].contiguous(), True)):
        n0 = st.separable_correlate2d_members.launches
        got = st.separable_correlate2d_members(xin, mt, adjoint, shared)
        want = st.separable_correlate2d_members_plain(xin, mt, adjoint,
                                                      shared)
        torch.cuda.synchronize()
        assert st.separable_correlate2d_members.launches == n0 + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["9x9", "4x3off"])
def test_stencil_members_equal_taps_give_the_single_launchs_bits(cuda, taps):
    """N equal tap sets through the per-member path: the bits of one
    single-tap-set launch over the batch."""
    for mode in ("constant", "symmetric"):
        p = _sep(taps, mode)
        mt = st.MemberTaps([p] * 3)
        for dtype in (torch.float32, torch.float64):
            x = torch.randn((2, 3, 300, 520), device=cuda, dtype=dtype)
            for adjoint in (False, True):
                got = st.separable_correlate2d_members(x, mt, adjoint)
                want = st.separable_correlate2d(x, p, adjoint)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (mode, dtype, adjoint)


@pytest.mark.cuda
def test_stencil_members_reads_stay_in_the_image(cuda):
    lib = st._library(("ST_COUNT_STRAY_READS",))[0]
    assert lib.stencil_stray_reads() == 0
    x = torch.randn((2, 3, 67, 129), device=cuda, dtype=torch.float64)
    for taps in ("9x9", "4x3off"):
        for mode in ("constant", "symmetric"):
            mt = _members(taps, mode)
            for adjoint in (False, True):
                for xin, shared in ((x, False), (x[:, 0].contiguous(), True)):
                    got = st._launch_members(lib, xin, mt, adjoint, shared)
                    want = st.separable_correlate2d_members_plain(
                        xin, mt, adjoint, shared)
                    torch.cuda.synchronize()
                    assert lib.stencil_stray_reads() == 0
                    assert float((got - want).abs().max()) <= 1e-10 * float(
                        x.abs().max())


@pytest.mark.cuda
def test_stencil_block_diag_and_stack_card_vs_cpu(cuda):
    """A homogeneous block_diag and stack of 2-D Stencils: one launch a
    block_diag apply or adjoint and a stack apply on the card (per-member
    taps, or the single-tap-set kernel when the taps are equal; a stack's
    adjoint loops, one a member, as in the JAX package), the CPU's
    numbers."""
    import pyxu_tpu_torch.operator as O
    shape = (70, 90)
    ks = [_gauss(9, s) for s in (1.2, 1.6, 2.0)]
    for taps in (ks, [ks[0]] * 3):
        ops = [O.Stencil(shape, [k, k], [4, 4], mode="symmetric")
               for k in taps]
        for blk, xs, want_n in ((O.block_diag(ops), (2, 3) + shape, 2),
                                (O.stack(ops), (2,) + shape, 4)):
            assert blk.batched_path == "stencil"
            x = torch.randn(xs, device=cuda)
            y = torch.randn((2, 3) + shape, device=cuda)
            n0 = (st.separable_correlate2d.launches
                  + st.separable_correlate2d_members.launches)
            got = blk.apply(x)
            back = blk.adjoint(y)
            torch.cuda.synchronize()
            n = (st.separable_correlate2d.launches
                 + st.separable_correlate2d_members.launches - n0)
            assert n == want_n
            for g, w in ((got, blk.apply(x.cpu())),
                         (back, blk.adjoint(y.cpu()))):
                assert float((g.cpu() - w).abs().max()) <= 2e-6 * max(
                    1.0, float(w.abs().max()))


# the Hessian's three partials (central accuracy 2): d2/dx0^2, the cross
# partial scaled by sqrt(2) (the Frobenius stack's weight), d2/dx1^2
HESS_TAPS = {"d00": ((1.0, -2.0, 1.0), 1, (1.0,), 0),
             "d01": (tuple(math.sqrt(2) * v for v in (-0.5, 0.0, 0.5)), 1,
                     (-0.5, 0.0, 0.5), 1),
             "d11": ((1.0,), 0, (1.0, -2.0, 1.0), 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
@pytest.mark.parametrize("taps", sorted(HESS_TAPS))
@pytest.mark.parametrize("shape", [(300, 520), (257, 389), (3, 67, 129)],
                         ids=str)
def test_stencil_kernel_at_the_hessian_taps(cuda, shape, taps, mode,
                                            adjoint, dtype):
    k0, c0, k1, c1 = HESS_TAPS[taps]
    p = st.SepTaps(k0=k0, c0=c0, k1=k1, c1=c1, mode=mode)
    assert st.kernel_takes(p)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape)).to(
        getattr(torch, dtype)).to(cuda)
    n0 = st.separable_correlate2d.launches
    got = st.separable_correlate2d(x, p, adjoint)
    want = st.separable_correlate2d_plain(x, p, adjoint)
    torch.cuda.synchronize()
    assert st.separable_correlate2d.launches == n0 + 1
    tol = (1e-5 if dtype == "float32" else 1e-12) * float(x.abs().max()) \
        * max(1.0, float(np.sum(np.abs(k0)) * np.sum(np.abs(k1))))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_hessian_frobenius_stack_card_vs_cpu(cuda):
    """The Hessian-Frobenius stack and its adjoint on the card against the
    CPU: three stencil launches each way."""
    from pyxu_tpu_torch.operator import Hessian, vstack
    shape = (200, 180)
    ops = {}
    for dev in ("cuda", "cpu"):
        ops[dev] = vstack([
            Hessian(shape, directions=(0, 0), mode="symmetric"),
            math.sqrt(2) * Hessian(shape, directions=(0, 1),
                                   mode="symmetric"),
            Hessian(shape, directions=(1, 1), mode="symmetric")])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape))
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3,) + shape))
    n0 = st.separable_correlate2d.launches
    y = ops["cuda"].apply(x.to(cuda))
    w = ops["cuda"].adjoint(z.to(cuda))
    torch.cuda.synchronize()
    assert st.separable_correlate2d.launches == n0 + 6
    assert float((y.cpu() - ops["cpu"].apply(x)).abs().max()) <= 1e-12 * 8
    assert float((w.cpu() - ops["cpu"].adjoint(z)).abs().max()) <= 1e-12 * 8


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


def _ref(plain, a, p):
    """The plain version in float64 on the plan's points: the reference
    of a kernel in either dtype (a float32 running sum of many products in
    one cell drifts further than the kernel's two-level sum)."""
    return plain(a.double(), p.astype(torch.float64))


def test_nufft_plan_astype_keeps_the_geometry():
    """``Plan.astype`` changes only the offsets' dtype; the plain
    versions run in the plan's dtype, and the float32 ones agree with
    their float64 reference."""
    p = _nu_plan("cluster", 3000, (50, 45), 7, torch.float32)
    q = p.astype(torch.float64)
    assert q.dtype == torch.float64 and q.bins == p.bins
    assert torch.equal(q.off.float(), p.off)
    for name in ("perm", "i0", "sub"):
        assert getattr(q, name) is getattr(p, name)
    gen = torch.Generator().manual_seed(2)
    c = torch.randn((1, 3000, 2), generator=gen)
    g = torch.randn((1, 50, 45, 2), generator=gen)
    # on one thread: a process's first multi-threaded index_add_ of this
    # CPU build of torch now and then sums wrong (ROADMAP Queue 3 item 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for plain, a in ((nu.nufft_spread2_plain, c),
                         (nu.nufft_interp2_plain, g)):
            got, want = plain(a, p), _ref(plain, a, p)
            assert got.dtype == torch.float32 and want.dtype == torch.float64
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
    finally:
        torch.set_num_threads(threads)


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
@pytest.mark.parametrize("w", range(2, 17))
@pytest.mark.parametrize("nf", [(64, 80), (50, 45), (20, 33)], ids=str)
@pytest.mark.parametrize("kind", NU_SETS)
def test_nufft_kernels_match_plain(cuda, kind, nf, w, dtype):
    """Spread and interp on the card against their plain versions, over
    the point sets, grid sides that are not multiples of the bin (and one
    smaller than a subgrid), every tap count the interp is built for
    (2-16), both dtypes and a batch of 2."""
    dt = getattr(torch, dtype)
    p = _nu_plan(kind, 2500, nf, w, dt, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    c = torch.randn((2, 2500, 2), generator=gen, device=cuda, dtype=dt)
    g = torch.randn((2,) + nf + (2,), generator=gen, device=cuda, dtype=dt)
    n0 = (nu.nufft_spread2.launches, nu.nufft_interp2.launches)
    gk, gp = nu.nufft_spread2(c, p), _ref(nu.nufft_spread2_plain, c, p)
    vk, vp = nu.nufft_interp2(g, p), _ref(nu.nufft_interp2_plain, g, p)
    torch.cuda.synchronize()
    assert (nu.nufft_spread2.launches, nu.nufft_interp2.launches) == (
        n0[0] + 1, n0[1] + 1)
    # the taps' summation order differs from the plain version's (the
    # spread sums without atomics, in an order the plan fixes)
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
    gp, vp = (_ref(nu.nufft_spread2_plain, c, p),
              _ref(nu.nufft_interp2_plain, g, p))
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


# ------------------------------------------------------------- 3-D NUFFT --

NU3_SETS = ["uniform", "cluster", "origin", "edges"]


def _nu3_points(kind, M, seed=0):
    """(M, 3) points in [-pi, pi]: uniform, a clustered Gaussian, a set
    with half its points at the origin (as a radial 3-D acquisition puts
    every spoke's centre there), and points at 0 and just below 2 pi."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-np.pi, np.pi, (M, 3))
    if kind == "cluster":
        return np.clip(rng.normal(0.3, 0.35, (M, 3)), -np.pi, np.pi)
    if kind == "origin":
        x = rng.uniform(-np.pi, np.pi, (M, 3))
        x[: M // 2] = 0.0
        return x
    if kind == "edges":
        vals = np.array([0.0, -0.0, np.nextafter(2 * np.pi, 0), -1e-300,
                         np.pi, -np.pi, np.nextafter(np.pi, 0), 1e-300])
        return rng.choice(vals, (M, 3))
    raise ValueError(kind)


def _nu3_plan(kind, M, nf, w, dtype, device="cpu", seed=0):
    x = torch.remainder(torch.from_numpy(_nu3_points(kind, M, seed)),
                        2 * np.pi).to(device)
    return nu.plan3(x, nf, w, 2.3 * w, dtype)


def test_nufft3_bins_fit_shared_memory():
    """The bin rule: the largest bin whose subgrid fits half a block's
    227 KB of shared memory, and 8^3 (at most 194,672 B) where none
    does."""
    for dt, cell in ((torch.float32, 8), (torch.float64, 16)):
        for w in range(2, nu.MAX_W + 1):
            bins = nu.bin3(w, dt)
            smem = cell * math.prod(b + w - 1 for b in bins)
            assert smem <= (nu.SMEM_MAX // 2 if bins != (8,) * 3
                            else 194_672)
            larger = {(16, 16, 16): [], (16, 16, 8): [(16, 16, 16)],
                      (8, 8, 8): [(16, 16, 16), (16, 16, 8)]}[bins]
            for big in larger:                  # no larger bin fits
                assert cell * math.prod(b + w - 1 for b in big) \
                    > nu.SMEM_MAX // 2
    assert nu.bin3(7, torch.float32) == (16, 16, 16)
    assert nu.bin3(16, torch.float64) == (8, 8, 8)
    p = _nu3_plan("uniform", 10, (40, 36, 33), 7, torch.float32)
    assert p.bins == (16, 16, 16) and p.nbins == (3, 3, 3)


def test_nufft3_plan_covers_every_point_once():
    for kind in NU3_SETS:
        p = _nu3_plan(kind, 3000, (40, 36, 33), 7, torch.float64)
        assert sorted(p.perm.tolist()) == list(range(3000))
        sub = p.sub.long()
        assert int(sub[:, 2].sum()) == 3000
        assert int(sub[:, 2].max()) <= nu.MAX_SUB and int(sub[:, 2].min()) > 0
        assert sub[0, 1] == 0 and torch.equal(sub[1:, 1],
                                              sub[:-1, 1] + sub[:-1, 2])
        base = p.i0.long() + p.w // 2
        assert int(base.min()) >= 0 and all(
            int(base[a].max()) < p.nf[a] for a in range(3))
        bins = ((base[0] // p.bins[0]) * p.nbins[1]
                + base[1] // p.bins[1]) * p.nbins[2] + base[2] // p.bins[2]
        owner = torch.repeat_interleave(sub[:, 0], sub[:, 2])
        assert torch.equal(bins, owner)
        assert float(p.off.min()) > p.w / 2 - 1
        assert float(p.off.max()) <= p.w / 2
    # 1500 points at the origin share one bin: two subproblems
    p = _nu3_plan("origin", 3000, (40, 36, 33), 7, torch.float64)
    assert int((p.sub[:, 0] == p.sub[0, 0]).sum()) >= 2


@pytest.mark.parametrize("kind", NU3_SETS)
def test_nufft3_plain_spread_interp_are_adjoint(kind, monkeypatch):
    """Over several chunks of points: the chunk bound lowered to 50
    points' taps."""
    p = _nu3_plan(kind, 500, (20, 18, 12), 5, torch.float64)
    monkeypatch.setattr(nu, "TAPS_PER_CHUNK", 50 * 5 ** 3)
    assert len(nu._chunks(p)) == 10
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.standard_normal((2, 500, 2)))
    g = torch.from_numpy(rng.standard_normal((2, 20, 18, 12, 2)))
    lhs = float(torch.sum(nu.nufft_spread3_plain(c, p) * g))
    rhs = float(torch.sum(c * nu.nufft_interp3_plain(g, p)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_nufft3_plain_matches_a_loop():
    """The plain spread and interp against point-by-point loops in numpy,
    on a grid smaller than a subgrid."""
    p = _nu3_plan("edges", 20, (12, 10, 9), 4, torch.float64)
    rng = np.random.default_rng(2)
    c = rng.standard_normal((1, 20, 2))
    g = rng.standard_normal((1, 12, 10, 9, 2))
    got = nu.nufft_spread3_plain(torch.from_numpy(c), p).numpy()[0]
    got_v = nu.nufft_interp3_plain(torch.from_numpy(g), p).numpy()[0]
    want = np.zeros((12, 10, 9, 2))
    want_v = np.zeros((20, 2))
    perm, i0, off = p.perm.numpy(), p.i0.numpy(), p.off.numpy()
    for j in range(20):
        ws = [nu.es_weights(torch.tensor(off[a, j]), 4, p.beta).numpy()
              for a in range(3)]
        for t in np.ndindex(4, 4, 4):
            cell = tuple((i0[a, j] + t[a]) % p.nf[a] for a in range(3))
            wt = ws[0][t[0]] * ws[1][t[1]] * ws[2][t[2]]
            want[cell] += c[0, perm[j]] * wt
            want_v[perm[j]] += g[(0,) + cell] * wt
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-13)


def test_nufft3_wrappers_cpu_plain_and_meta_raise():
    p = _nu3_plan("uniform", 300, (20, 18, 12), 7, torch.float32)
    p2 = _nu_plan("uniform", 300, (40, 36), 7, torch.float32)
    c = torch.randn((1, 300, 2))
    g = torch.randn((1, 20, 18, 12, 2))
    n0 = (nu.nufft_spread3.launches, nu.nufft_interp3.launches)
    assert torch.equal(nu.nufft_spread3(c, p), nu.nufft_spread3_plain(c, p))
    assert torch.equal(nu.nufft_interp3(g, p), nu.nufft_interp3_plain(g, p))
    with pytest.raises(ValueError):
        nu.nufft_spread3(c.to("meta"), p)
    with pytest.raises(ValueError):
        nu.nufft_interp3(g.to("meta"), p)
    with pytest.raises(ValueError, match="3-D function"):
        nu.nufft_spread3(c, p2)
    with pytest.raises(ValueError, match="2-D function"):
        nu.nufft_interp2(g, p)
    assert (nu.nufft_spread3.launches, nu.nufft_interp3.launches) == n0


# ----------------------------------------------- the spread's task geometry --

def _geom_cases():
    """(d, point set, grid, w, dtype, SPLIT): both dimensions, a dense
    bin cut into slabs (a low SPLIT stands for a dense bin at test size),
    grids smaller than a tile, w = 2, 7 and 16 in both dtypes (8^3 bins at
    w = 16 in float64)."""
    out = []
    for dt in ("float32", "float64"):
        for w in (2, 7, 16):
            out += [(3, "origin", (40, 36, 33), w, dt, 64),
                    (3, "uniform", (12, 20, 9), w, dt, nu.SPLIT),
                    (2, "onebin", (64, 80), w, dt, 64),
                    (2, "gauss", (20, 33), w, dt, nu.SPLIT)]
    return out


def _geom_plan(d, kind, nf, w, dt, M=2000):
    if d == 3:
        return _nu3_plan(kind, M, nf, w, getattr(torch, dt))
    return _nu_plan(kind, M, nf, w, getattr(torch, dt))


def _geom_id(case):
    d, kind, nf, w, dt, split = case
    return f"{d}d-{kind}-{'x'.join(map(str, nf))}-w{w}-{dt}-split{split}"


@pytest.mark.parametrize("case", _geom_cases(), ids=_geom_id)
def test_nufft_spread_tasks_cover_every_cell_once(case, monkeypatch):
    """Every grid cell belongs to exactly one task, and each task's
    threads hold its box: ``planes`` x ``rows`` (3-D) rows cut into
    patches of ``run`` cells, at most ``THREADS`` of them."""
    d, kind, nf, w, dt, split = case
    monkeypatch.setattr(nu, "SPLIT", split)
    p = _geom_plan(d, kind, nf, w, dt)
    t = nu.spread_tasks(p)
    hits = torch.zeros(nf, dtype=torch.int64)
    for o, e in zip(t["origin"].tolist(), t["extent"].tolist()):
        hits[tuple(slice(a, a + b) for a, b in zip(o, e))] += 1
    assert bool((hits == 1).all())
    bins, planes, rows, run = p.bins, t["planes"], t["rows"], t["run"]
    for v in (planes, rows, run):
        assert bool(((v & (v - 1)) == 0).all())
    assert bool((run <= nu.MAX_RUN[d]).all())
    # a thread's patch: run / rt rows (3-D) by rt = min(run, 4) cells
    rt = torch.clamp(run, max=4)
    assert bool((bins[-1] % rt == 0).all())
    assert bool((rows % (run // rt) == 0).all())
    cells = planes * rows * bins[-1]
    assert bool((cells // run <= nu.THREADS).all())
    assert bool((run == torch.clamp(cells // nu.THREADS, min=1)).all())
    assert bool((t["extent"][:, 0] <= planes).all())
    assert bool((t["origin"][:, 0] % planes == 0).all())
    if d == 3:
        assert bool((t["extent"][:, 1] <= rows).all())
        assert bool((t["origin"][:, 1] % rows == 0).all())
        assert bool((rows <= bins[1]).all())
    else:
        assert bool((rows == 1).all())
    assert bool((t["origin"][:, -1] % bins[-1] == 0).all())
    assert bool((t["extent"][:, -1] <= bins[-1]).all())
    if split < nu.SPLIT:                # the dense bin is cut into parts
        assert int(cells.min()) < int(cells.max())


@pytest.mark.parametrize("case", _geom_cases(), ids=_geom_id)
def test_nufft_spread_tasks_list_every_reaching_point(case, monkeypatch):
    """Brute force: every point with a tap on a task's cells lies in a
    spread bin of the task's neighbourhood, and none is listed twice."""
    d, kind, nf, w, dt, split = case
    monkeypatch.setattr(nu, "SPLIT", split)
    p = _geom_plan(d, kind, nf, w, dt)
    t = nu.spread_tasks(p)
    taps = torch.arange(w)
    reach = torch.ones((p.tasks.shape[0], p.M), dtype=torch.bool)
    listed = torch.ones_like(reach)
    for a in range(d):
        cells = (p.i0[a].long()[:, None] + taps) % nf[a]       # (M, w)
        o = t["origin"][:, a, None, None]
        e = t["extent"][:, a, None, None]
        reach &= ((cells >= o) & (cells < o + e)).any(-1)
        cnt = t["cnt"][:, a]
        assert bool((cnt <= p.nsbins[a]).all())
        b = (p.i0[a].long() + w // 2) // p.sbins[a]      # the spread bin
        k = (b[None, :] - t["lo"][:, a, None]) % p.nsbins[a]
        listed &= k < cnt[:, None]
    assert bool(reach.any(0).all())        # every point reaches a task
    assert bool((~reach | listed).all())
    assert int(t["cnt"].prod(1).max()) <= nu.MAX_SEG


@pytest.mark.parametrize("d", [2, 3])
def test_nufft_bin_tables_agree_with_sub(d):
    """``sbstart``/``sbcount`` give each spread bin's sorted points, one
    run each, nested in the bins; summed over a bin they give the bin's
    points as the subproblems that cut it do."""
    for kind in (NU3_SETS if d == 3 else NU_SETS):
        p = _geom_plan(d, kind, (40, 36, 33) if d == 3 else (50, 45), 7,
                       "float32", M=3000)
        nsb = math.prod(p.nsbins)
        assert p.sbstart.shape == p.sbcount.shape == (nsb,)
        assert p.sbstart.dtype == p.sbcount.dtype == torch.int32
        assert all(b % s == 0 for b, s in zip(p.bins, p.sbins))
        base = p.i0.long() + p.w // 2
        sb = torch.zeros(p.M, dtype=torch.int64)
        for a in range(d):
            sb = sb * p.nsbins[a] + base[a] // p.sbins[a]
        # each spread bin's points are the run sbstart + [0, sbcount)
        start, count = p.sbstart.long(), p.sbcount.long()
        assert torch.equal(torch.bincount(sb, minlength=nsb), count)
        has = count > 0
        owner = torch.repeat_interleave(torch.arange(nsb)[has], count[has])
        assert torch.equal(sb[torch.cat([
            torch.arange(a, a + n) for a, n in zip(start[has].tolist(),
                                                   count[has].tolist())])],
            owner)
        # per bin: the runs of its spread bins make the subproblems' run
        coords = torch.stack(torch.meshgrid(
            *[torch.arange(n) for n in p.nsbins], indexing="ij"), -1)
        bin_of = torch.zeros(p.nsbins, dtype=torch.int64)
        for a in range(d):
            bin_of = bin_of * p.nbins[a] + coords[..., a] // (
                p.bins[a] // p.sbins[a])
        bin_of = bin_of.reshape(-1)
        nbins = math.prod(p.nbins)
        bcount = torch.zeros(nbins, dtype=torch.int64).index_add_(
            0, bin_of, count)
        big = torch.iinfo(torch.int64).max
        bfirst = torch.full((nbins,), big).scatter_reduce(
            0, bin_of[has], start[has], "amin")
        sub = p.sub.long()
        scount = torch.zeros(nbins, dtype=torch.int64).index_add_(
            0, sub[:, 0], sub[:, 2])
        sfirst = torch.full((nbins,), big).scatter_reduce(
            0, sub[:, 0], sub[:, 1], "amin")
        assert torch.equal(bcount, scount)
        assert torch.equal(bfirst, sfirst)


def _interp_cases():
    """(d, point set, grid, w, dtype): a dense bin cut into several
    subproblems and a grid with a side under w (1 at w = 2), in both
    dimensions, w = 2, 7 and 16, both dtypes' bin rules."""
    out = []
    for dt in ("float32", "float64"):
        for w in (2, 7, 16):
            small = max(1, w - 3)
            out += [(3, "origin", (40, 36, 33), w, dt),
                    (3, "uniform", (12, small, 9), w, dt),
                    (2, "onebin", (64, 80), w, dt),
                    (2, "gauss", (20, small), w, dt)]
    return out


@pytest.mark.parametrize(
    "case", _interp_cases(),
    ids=lambda c: f"{c[0]}d-{c[1]}-{'x'.join(map(str, c[2]))}-w{c[3]}-{c[4]}")
def test_nufft_interp_reads_stay_in_the_subgrid(case):
    """Brute force over the interp kernel's reads (``tap_shape``,
    ``interp_subgrid``; a group's lanes in 3-D, a thread's taps in 2-D):
    along each axis, each point of each subproblem reads each of its w
    taps once with a nonzero weight, at the subgrid index whose grid cell
    (origin + index mod n) is the tap's, and every read, used or not, lies
    inside the loaded sides."""
    d, kind, nf, w, dt = case
    dtype = getattr(torch, dt)
    p = _geom_plan(d, kind, nf, w, dt, M=3000)
    sh, sg = nu.tap_shape(w, dtype), nu.interp_subgrid(p.bins, w, dtype)
    C, L, R, K = sh["C"], sh["L"], sh["R"], sh["K"]
    assert sg["group"] == (d == 3)
    assert L * R == nu.GROUP and C * L >= w + C - 1 and K * R >= w
    assert sg["smem"] <= nu.SMEM_MAX and sg["sides"][-1] <= sg["pitch"]
    sub = p.sub.long()
    if kind in ("origin", "onebin"):        # a dense bin, several blocks
        assert int(torch.bincount(sub[:, 0]).max()) >= 2
    # each sorted point's bin, and the bin's coordinates (row-major)
    owner = torch.repeat_interleave(sub[:, 0], sub[:, 2])
    coords, rest = [], owner
    for ax in reversed(range(d)):
        coords.append(rest % p.nbins[ax])
        rest = rest // p.nbins[ax]
    coords.reverse()
    M = p.M
    for ax in range(d):
        x0 = sh["X0"] if ax == d - 1 else 0
        o = coords[ax] * p.bins[ax] - w // 2 - x0    # the subgrid's origin
        i0 = p.i0[ax].long()
        li = i0 - o
        assert int(li.min()) >= x0 and int(li.max()) < p.bins[ax] + x0
        if ax == d - 1 and sh["E"] == 2:   # rows start on 16 bytes
            assert bool((o % 2 == 0).all()) and sg["sides"][ax] % 2 == 0
            assert sg["pitch"] % 2 == 0
        if not sg["group"]:     # a thread reads each tap
            t = torch.arange(w).expand(M, -1)
            idx = li[:, None] + t
        elif ax == d - 1:       # lanes j, C cells each, from an aligned start
            j = torch.arange(L)[None, :, None]
            e = torch.arange(C)[None, None, :]
            s0 = (li % C)[:, None, None]
            jmax = (w - 1 + s0) // C
            t = C * j + e - s0
            idx = li[:, None, None] - s0 + C * torch.minimum(j, jmax) + e
        elif ax == d - 2:       # row r of step k, the last row again past w
            t = (torch.arange(K)[:, None] * R + torch.arange(R)).reshape(-1)
            idx = li[:, None] + torch.clamp(t, max=w - 1)
            t = t.expand(M, -1)
        else:                   # the planes
            t = torch.arange(w).expand(M, -1)
            idx = li[:, None] + t
        t, idx = t.reshape(M, -1), idx.reshape(M, -1)
        used = (t >= 0) & (t < w)
        assert int(idx.min()) >= 0 and int(idx.max()) < sg["sides"][ax]
        hits = torch.zeros((M, w), dtype=torch.int64).scatter_add_(
            1, torch.clamp(t, 0, w - 1), used.long())
        assert bool((hits == 1).all())
        cell = (o[:, None] + idx) % nf[ax]
        want = (i0[:, None] + t) % nf[ax]
        assert bool(((cell == want) | ~used).all())


@pytest.mark.parametrize("b", [2, 8, 16, 32])
@pytest.mark.parametrize("w", [2, 3, 7, 16])
def test_nufft_neighbourhood_matches_brute_force(b, w):
    """Along one axis, for every task box (origin, extent) of grids of 1
    to 70 cells: the listed bins are those holding a base that taps the
    box, each once (all bins where the bases cover the axis)."""
    for n in (1, 5, 9, 17, 33, 70):
        nb = -(-n // b)
        o, e = [], []
        for o0 in range(0, n, max(1, b // 2)):
            for e0 in {1, min(b, n - o0), max(1, min(b, n - o0) // 2)}:
                o.append(o0)
                e.append(e0)
        lo, cnt = nu.neighbourhood(torch.tensor(o), torch.tensor(e), n, b,
                                   nb, w)
        for o0, e0, l0, c0 in zip(o, e, lo.tolist(), cnt.tolist()):
            got = [(l0 + k) % nb for k in range(c0)]
            assert len(set(got)) == len(got) <= nb
            want = {base // b for base in range(n)
                    for t in range(w)
                    if o0 <= (base - w // 2 + t) % n < o0 + e0}
            assert want <= set(got), (n, o0, e0)
            if want:
                assert set(got) == want or len(got) == nb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("w", range(2, 17))
@pytest.mark.parametrize("nf", [(40, 36, 33), (12, 20, 9)], ids=str)
@pytest.mark.parametrize("kind", NU3_SETS)
def test_nufft3_kernels_match_plain(cuda, kind, nf, w, dtype):
    """Spread and interp on the card against their plain versions, over
    the point sets, a grid whose sides are not multiples of the bin and
    one smaller than a subgrid, every tap count the interp is built for
    (2-16; at w = 16 in float64 the subgrid takes 194,672 B of shared
    memory), both dtypes and a batch of 2."""
    dt = getattr(torch, dtype)
    p = _nu3_plan(kind, 2500, nf, w, dt, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    c = torch.randn((2, 2500, 2), generator=gen, device=cuda, dtype=dt)
    g = torch.randn((2,) + nf + (2,), generator=gen, device=cuda, dtype=dt)
    n0 = (nu.nufft_spread3.launches, nu.nufft_interp3.launches)
    gk, gp = nu.nufft_spread3(c, p), _ref(nu.nufft_spread3_plain, c, p)
    vk, vp = nu.nufft_interp3(g, p), _ref(nu.nufft_interp3_plain, g, p)
    torch.cuda.synchronize()
    assert (nu.nufft_spread3.launches, nu.nufft_interp3.launches) == (
        n0[0] + 1, n0[1] + 1)
    # the taps' summation order differs from the plain version's (the
    # spread sums without atomics, in an order the plan fixes)
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * float(gp.abs().max())
    assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("M", [0, 1, 3])
def test_nufft3_kernels_few_points(cuda, M, dtype):
    dt = getattr(torch, dtype)
    p = _nu3_plan("edges", M, (40, 36, 33), 7, dt, cuda)
    c = torch.randn((1, M, 2), device=cuda, dtype=dt)
    g = torch.randn((1, 40, 36, 33, 2), device=cuda, dtype=dt)
    gk, vk = nu.nufft_spread3(c, p), nu.nufft_interp3(g, p)
    gp, vp = (_ref(nu.nufft_spread3_plain, c, p),
              _ref(nu.nufft_interp3_plain, g, p))
    torch.cuda.synchronize()
    assert gk.shape == (1, 40, 36, 33, 2) and vk.shape == (1, M, 2)
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * max(float(gp.abs().max()), 1)
    if M == 0:
        assert not gk.any()
    else:
        assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())


def _spread_case(d, kind, M, nf, w, dt, cuda, seed=3):
    p = (_nu3_plan if d == 3 else _nu_plan)(kind, M, nf, w, dt, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = torch.randn((2, M, 2), generator=gen, device=cuda, dtype=dt)
    spread = nu.nufft_spread3 if d == 3 else nu.nufft_spread2
    plain = nu.nufft_spread3_plain if d == 3 else nu.nufft_spread2_plain
    return p, c, spread, plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_spread_launches_are_bit_identical(cuda, d, dtype):
    """No atomics: two launches give the same bits, on every point set."""
    dt = getattr(torch, dtype)
    nf = (40, 36, 33) if d == 3 else (64, 80)
    for kind in (NU3_SETS if d == 3 else NU_SETS):
        p, c, spread, _ = _spread_case(d, kind, 5000, nf, 7, dt, cuda)
        assert torch.equal(spread(c, p), spread(c, p)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_spread_dense_bin_split_by_cells(cuda, d, dtype):
    """70,000 points, half or all of them in one bin: the plan cuts the
    tiles around it into slabs of cells and leaves the far ones whole;
    against the plain version, and two launches bit-identical."""
    dt = getattr(torch, dtype)
    kind, nf = (("origin", (80, 72, 66)) if d == 3
                else ("onebin", (256, 200)))
    p, c, spread, plain = _spread_case(d, kind, 70_000, nf, 7, dt, cuda)
    t = nu.spread_tasks(p)
    cells = t["planes"] * t["rows"]
    assert int(cells.min()) < int(cells.max())
    gk, gp = spread(c, p), _ref(plain, c, p)
    assert torch.equal(gk, spread(c, p))
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * float(gp.abs().max())


def _interp_case(d, kind, M, nf, w, dt, cuda, seed=3):
    p = (_nu3_plan if d == 3 else _nu_plan)(kind, M, nf, w, dt, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = torch.randn((2,) + nf + (2,), generator=gen, device=cuda, dtype=dt)
    interp = nu.nufft_interp3 if d == 3 else nu.nufft_interp2
    plain = nu.nufft_interp3_plain if d == 3 else nu.nufft_interp2_plain
    return p, g, interp, plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_interp_launches_are_bit_identical(cuda, d, dtype):
    """Each point summed by one group in a fixed order: two launches give
    the same bits, on every point set."""
    dt = getattr(torch, dtype)
    nf = (40, 36, 33) if d == 3 else (64, 80)
    for kind in (NU3_SETS if d == 3 else NU_SETS):
        p, g, interp, _ = _interp_case(d, kind, 5000, nf, 7, dt, cuda)
        assert torch.equal(interp(g, p), interp(g, p)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_interp_dense_bin_several_blocks(cuda, d, dtype):
    """70,000 points, half or all of them in one bin, which the plan cuts
    into many subproblems (blocks) that load the same subgrid: against
    the plain version, and two launches bit-identical."""
    dt = getattr(torch, dtype)
    kind, nf = (("origin", (80, 72, 66)) if d == 3
                else ("onebin", (256, 200)))
    p, g, interp, plain = _interp_case(d, kind, 70_000, nf, 7, dt, cuda)
    assert int(torch.bincount(p.sub[:, 0].long()).max()) >= 34
    vk, vp = interp(g, p), _ref(plain, g, p)
    assert torch.equal(vk, interp(g, p))
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_interp_grid_offsets(cuda, d, dtype):
    """A grid that starts one cell into its storage (8 or 16 bytes, not
    16-byte aligned in float32: the rows copy a cell at a time) matches
    the plain version; one that starts half a cell in raises."""
    dt = getattr(torch, dtype)
    nf = (40, 36, 34) if d == 3 else (64, 80)
    p, g, interp, plain = _interp_case(d, "cluster", 3000, nf, 7, dt, cuda)
    flat = torch.zeros(g.numel() + 2, dtype=dt, device=cuda)
    shifted = flat[2:].view(g.shape)
    shifted.copy_(g)
    vk, vp = interp(shifted, p), _ref(plain, g, p)
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((vk - vp).abs().max()) <= rel * float(vp.abs().max())
    with pytest.raises(ValueError, match="whole"):
        interp(flat[1:-1].view(g.shape), p)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 7, 16])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_kernels_are_adjoint(cuda, d, w):
    """The kernel pair in float64: <spread(c), g> = <c, interp(g)> within
    1e-12 of the larger side."""
    nf = (40, 36, 33) if d == 3 else (64, 80)
    p, g, interp, _ = _interp_case(d, "cluster", 4000, nf, w, torch.float64,
                                   cuda)
    spread = nu.nufft_spread3 if d == 3 else nu.nufft_spread2
    gen = torch.Generator(device=cuda).manual_seed(5)
    c = torch.randn((2, 4000, 2), generator=gen, device=cuda,
                    dtype=torch.float64)
    lhs = float(torch.sum(spread(c, p) * g))
    rhs = float(torch.sum(c * interp(g, p)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [16, 256, 2048])
@pytest.mark.parametrize("w", [2, 7, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [2, 3])
def test_nufft_spread_split_tasks_match_plain(cuda, monkeypatch, d, dtype,
                                              w, split):
    """Every run length of the kernel (1 to 16 cells a thread): SPLIT
    lowered so that bins are cut into slabs of 1 to 16 planes (and, in
    3-D, strips of 1 to 8 rows) at test size."""
    monkeypatch.setattr(nu, "SPLIT", split)
    dt = getattr(torch, dtype)
    kind, nf = ("cluster", (40, 36, 33)) if d == 3 else ("gauss", (50, 45))
    p, c, spread, plain = _spread_case(d, kind, 3000, nf, w, dt, cuda)
    gk, gp = spread(c, p), _ref(plain, c, p)
    rel = 1e-5 if dtype == "float32" else 1e-12
    assert float((gk - gp).abs().max()) <= rel * float(gp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["type1", "type2"])
def test_nufft3_operator_on_the_card(cuda, kind):
    """The 3-D NUFFT and its Toeplitz gram on the card against the same
    operators on the CPU (plain versions), float64, 1e-9 of the largest
    value (cuFFT and the CPU's FFT round in another order)."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    x = _nu3_points("cluster", 3000)
    ops = {dev: getattr(NUFFT, kind)(x, (16, 20, 12), eps=1e-8,
                                     dtype=torch.float64, device=dev)
           for dev in ("cpu", cuda)}
    assert ops[cuda].kernel_path == "kernel"
    f = torch.randn((2,) + ops["cpu"].dim_shape, dtype=torch.float64)
    y = torch.randn((2,) + ops["cpu"].codim_shape, dtype=torch.float64)
    for name in ("apply", "adjoint"):
        a = f if name == "apply" else y
        want = getattr(ops["cpu"], name)(a)
        got = getattr(ops[cuda], name)(a.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-9 * float(
            want.abs().max())
    if kind == "type2":
        want = ops["cpu"].gram().apply(f)
        got = ops[cuda].gram().apply(f.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-9 * float(
            want.abs().max())


def _card_vs_cpu(ops, cuda, inputs):
    """Each (method, input) on the card against the CPU operator: 1e-9 of
    the largest value (cuFFT and the CPU's FFT round in another order)."""
    for name, a in inputs:
        want = getattr(ops["cpu"], name)(a)
        got = getattr(ops[cuda], name)(a.to(cuda)).cpu()
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-9 * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d,isign,real,chunked", [
    (2, 1, False, False), (2, -1, True, False), (3, -1, False, False),
    (3, 1, True, False), (2, 1, False, True), (3, -1, False, True)])
def test_nufft_type3_on_the_card(cuda, d, isign, real, chunked):
    """Type 3 on the card against the same operator on the CPU (plain
    versions), float64: an apply and an adjoint launch the spread and the
    interp of d dimensions twice each (a chunked plan twice a block)."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    rng = np.random.default_rng(d + 2 * isign)
    x = rng.uniform(-1.0, 2.0, (3000, d))
    z = rng.uniform(-15.0, 12.0, (2000, d))
    kw = dict(chunked=True, fft_mem_mb={2: 0.05, 3: 0.5}[d]) if chunked \
        else {}
    ops = {dev: NUFFT.type3(x, z, isign=isign, real=real, eps=1e-8,
                            dtype=torch.float64, device=dev, **kw)
           for dev in ("cpu", cuda)}
    assert ops[cuda].kernel_path == "kernel"
    blocks = 1
    if chunked:
        assert ops[cuda].stats() == ops["cpu"].stats()
        blocks = len(ops[cuda].params())
        assert blocks > 1
    spread = nu.nufft_spread2 if d == 2 else nu.nufft_spread3
    interp = nu.nufft_interp2 if d == 2 else nu.nufft_interp3
    n0 = (spread.launches, interp.launches)
    c = torch.randn((2,) + ops["cpu"].dim_shape, dtype=torch.float64)
    f = torch.randn((2, 2000, 2), dtype=torch.float64)
    _card_vs_cpu(ops, cuda, (("apply", c), ("adjoint", f)))
    assert (spread.launches - n0[0], interp.launches - n0[1]) == (
        2 * blocks, 2 * blocks)


@pytest.mark.cuda
def test_nufft_d1_on_the_card(cuda):
    """d = 1 runs the plain spread and interp on the card (no kernel, no
    launch): types 1, 2 and 3 against the CPU."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    rng = np.random.default_rng(1)
    x, z = rng.uniform(-np.pi, np.pi, 500), rng.uniform(-40, 40, 300)
    n0 = [k.launches for k in (nu.nufft_spread2, nu.nufft_interp2,
                               nu.nufft_spread3, nu.nufft_interp3)]
    for make in (lambda dev: NUFFT.type1(x, 64, eps=1e-8, device=dev,
                                         dtype=torch.float64),
                 lambda dev: NUFFT.type2(x, 64, eps=1e-8, device=dev,
                                         dtype=torch.float64),
                 lambda dev: NUFFT.type3(x, z, eps=1e-8, device=dev,
                                         dtype=torch.float64)):
        ops = {dev: make(dev) for dev in ("cpu", cuda)}
        assert ops[cuda].kernel_path == "plain"
        _card_vs_cpu(ops, cuda, (
            ("apply", torch.randn(ops["cpu"].dim_shape, dtype=torch.float64)),
            ("adjoint", torch.randn(ops["cpu"].codim_shape,
                                    dtype=torch.float64))))
    assert n0 == [k.launches for k in (nu.nufft_spread2, nu.nufft_interp2,
                                       nu.nufft_spread3, nu.nufft_interp3)]


@pytest.mark.cuda
def test_sparse_view_ct_on_the_card(cuda):
    """The CT path on the card against the same solve on the CPU (plain
    versions): FourierRadon at 48x48 / 16 views, its spread and interp in
    the set-up and the stencil in the iterations (4 launches an
    iteration), 40 PD3O iterations within 2e-4.  (FourierRadon and its
    gram at an odd fine-grid side are held on the card by the smoke
    script's CT phase.)"""
    from pyxu_tpu_torch.models import sparse_view_ct
    from pyxu_tpu_torch.opt.stop import MaxIter
    sols = {}
    for dev in (cuda, "cpu"):
        slv, fit, _ = sparse_view_ct((48, 48), n_angles=16, method="fourier",
                                     device=dev, stop_rate=40)
        n0 = st.separable_correlate2d.launches
        slv.fit(stop_crit=MaxIter(40), max_iter=40, **fit)
        if dev == cuda:
            assert st.separable_correlate2d.launches - n0 == 4 * 40
        sols[str(dev)] = slv.solution().cpu()
    assert float((sols["cuda"] - sols["cpu"]).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_tv_schedule_on_the_card(cuda, monkeypatch):
    """A precision schedule on the TV path at 96x67: the bf16 phase matches
    the fused kernels again and launches ``tv_step`` on bf16 storage, the
    f32 phase on f32; the result comes back in f32, its objective within
    1e-2 of the f32 solve's."""
    from pyxu_tpu_torch.convert import tv_problem
    from pyxu_tpu_torch.opt.stop import MaxIter
    y = np.random.default_rng(4).random((96, 67)).astype(np.float32)
    taps = (_gauss(), _gauss())
    seen = []
    launch = ft._launch

    def recording(entry, x, z, *args, **kw):
        seen.append((entry, x.dtype, z.dtype))
        return launch(entry, x, z, *args, **kw)
    monkeypatch.setattr(ft, "_launch", recording)
    objs = {}
    for sched in (None, [(torch.bfloat16, 40), (torch.float32, None)]):
        f, h, D, slv, fit = tv_problem(y, taps, (4, 4), device=cuda,
                                       stop_rate=10)
        seen.clear()
        n0 = ft.tv_step.launches
        slv.fit(stop_crit=MaxIter(60), max_iter=60, precision_schedule=sched,
                **fit)
        assert ft.tv_step.launches - n0 == 60 and len(seen) == 60
        x = slv.solution()
        assert x.dtype == torch.float32 and bool(x.isfinite().all())
        objs[sched is None] = float(f.apply(x) + h.apply(D.apply(x)))
    step = "tv_step_launch"
    assert seen == [(step, torch.bfloat16, torch.bfloat16)] * 40 + \
        [(step, torch.float32, torch.float32)] * 20
    assert [p["fused_path"] for p in slv.phase_log] == ["kernel", "kernel"]
    assert abs(objs[False] - objs[True]) <= 1e-2 * abs(objs[True]), objs


@pytest.mark.cuda
def test_stencil_schedule_bf16_phase_raises_on_the_card(cuda):
    """The stencil kernel takes float32 and float64 only, and nothing falls
    back: a LASSO schedule with a bfloat16 phase raises its ValueError and
    leaves the state of the phase's start."""
    from pyxu_tpu_torch.convert import lasso_problem
    from pyxu_tpu_torch.opt.stop import MaxIter
    y = np.random.default_rng(6).random((96, 67)).astype(np.float32)
    _, _, _, slv, fit = lasso_problem(y, (_gauss(), _gauss()), (4, 4),
                                      device=cuda, stop_rate=10)
    with pytest.raises(ValueError, match="float32 or float64"):
        slv.fit(stop_crit=MaxIter(30), max_iter=30,
                precision_schedule=[(torch.bfloat16, 20),
                                    (torch.float32, None)], **fit)
    assert slv.phase_log == [] and slv._mstate["x"].dtype == torch.bfloat16


@pytest.mark.cuda
def test_sessions_on_the_card(cuda):
    """warm_start and update_operands on the LASSO path at 96x67 (the
    stencil kernel, two launches an iteration) give the same bits as fresh
    solves; an ASYNC fit stops and its worker is joined."""
    import time

    from pyxu_tpu_torch.abc import Mode
    from pyxu_tpu_torch.convert import lasso_problem
    from pyxu_tpu_torch.opt.stop import ManualStop, MaxIter
    rng = np.random.default_rng(5)
    y1, y2 = (rng.random((96, 67)).astype(np.float32) for _ in range(2))
    taps = (_gauss(), _gauss())

    def fresh(y, n):
        _, _, _, slv, fit = lasso_problem(y, taps, (4, 4), device=cuda,
                                          stop_rate=10)
        slv.fit(stop_crit=MaxIter(n), max_iter=n, **fit)
        return slv, fit
    slv, fit = fresh(y1, 20)
    n0 = st.separable_correlate2d.launches
    slv.fit(stop_crit=MaxIter(20), max_iter=20, warm_start=True)
    assert st.separable_correlate2d.launches - n0 == 2 * 20
    assert torch.equal(slv.solution(), fresh(y1, 40)[0].solution())
    f2 = lasso_problem(y2, taps, (4, 4), device=cuda)[0]
    slv.update_operands(f=f2)
    slv.fit(stop_crit=MaxIter(30), max_iter=30, **fit)
    assert torch.equal(slv.solution(), fresh(y2, 30)[0].solution())
    slv.fit(stop_crit=ManualStop(), max_iter=10 ** 7, segment_size=10,
            mode=Mode.ASYNC, **fit)
    time.sleep(0.2)
    assert slv.busy()
    slv.stop()
    worker = slv._astate["worker"]
    assert not slv.busy() and not worker.is_alive()
    k = slv.stats()[1]["iteration"][-1]
    assert k > 0 and k % 10 == 0 and bool(slv.solution().isfinite().all())


def _uq_posterior(shape, device):
    """MYULA's deblurring posterior (``chip_smoke.py`` phase 14): workload
    1's sparse image and blur, y = K x + 0.01 n, f = 0.5 ||K x - y||^2 /
    0.01^2 and g = 0.05 ||x||_1 / 0.01^2."""
    from pyxu_tpu_torch.models import lasso_deconvolution
    from pyxu_tpu_torch.operator.func import L1Norm, SquaredL2Norm
    rng = np.random.default_rng(0)
    rng.random(shape)                       # the factory's x_true draw
    n = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, _, ex = lasso_deconvolution(shape, device=device)
    K = ex["K"]
    y = ex["y"] + 0.01 * n.to(device)
    f = (0.5 / 0.01 ** 2) * SquaredL2Norm(shape).asloss(y) * K
    return f, (0.05 / 0.01 ** 2) * L1Norm(shape), K, y


@pytest.mark.cuda
def test_myula_64x48_card_matches_cpu(cuda):
    """100 MYULA steps with the noise drawn on the CPU and fed to both
    devices: within 2e-4 of max|x|; two stencil launches a step on the
    card."""
    from pyxu_tpu_torch.sampler import MYULA
    shape = (64, 48)
    chains = {}
    for dev in ("cpu", cuda):
        f, g, K, _ = _uq_posterior(shape, dev)
        assert K.kernel_path == "kernel"
        chains[str(dev)] = MYULA(f, g)
    cpu, card = chains["cpu"], chains[str(cuda)]
    assert (card.gamma, card.lamb) == (cpu.gamma, cpu.lamb)
    gen = torch.Generator().manual_seed(0)
    x = {"cpu": torch.zeros(shape), "card": torch.zeros(shape, device=cuda)}
    card._update(x["card"], torch.zeros(shape, device=cuda))  # fills caches
    n0 = st.separable_correlate2d.launches
    for _ in range(100):
        w = torch.randn(shape, generator=gen)
        x["cpu"] = cpu._update(x["cpu"], w)
        x["card"] = card._update(x["card"], w.to(cuda))
    assert st.separable_correlate2d.launches - n0 == 2 * 100
    diff = float((x["card"].cpu() - x["cpu"]).abs().max())
    assert diff <= 2e-4 * float(x["cpu"].abs().max())


@pytest.mark.cuda
def test_pinv_64x48_card_matches_cpu(cuda):
    """Tikhonov deblurring by ``K.pinv(y, damp=1e-2)``: the card against
    the CPU within 2e-4 of max|x|, the dagger's same bits, and the
    stencil's launches: 2 a CG iteration, 1 for K^T y, 2 for the initial
    residual."""
    from pyxu_tpu_torch.math.cg import CHECK_RATE
    shape = (64, 48)
    sols = {}
    for dev in ("cpu", cuda):
        _, _, K, y = _uq_posterior(shape, dev)
        n0 = st.separable_correlate2d.launches
        sols[str(dev)] = K.pinv(y, damp=1e-2)
        n = st.separable_correlate2d.launches - n0
        assert torch.equal(K.dagger(1e-2).apply(y), sols[str(dev)])
    iters = (n - 3) // 2
    assert n == 3 + 2 * iters and iters % CHECK_RATE == 0 and iters > 0
    want = sols["cpu"]
    diff = float((sols[str(cuda)].cpu() - want).abs().max())
    assert diff <= 2e-4 * float(want.abs().max())


# ------------------------------------------------------ the parallel layer --

@pytest.fixture
def nccl1(cuda, tmp_path):
    """A NCCL group of one rank on a ``file://`` store, and its mesh."""
    import torch.distributed as dist

    import pyxu_tpu_torch.parallel as par
    assert par.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                                device="cuda") == 1
    assert dist.get_backend() == "nccl"
    try:
        yield par.auto_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["constant", "wrap"])
@pytest.mark.parametrize("shard_axis", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_stencil_launches_the_kernel(nccl1, mode, shard_axis, dtype):
    """ShardedStencil's local correlation runs the stencil kernel, one
    launch an apply or adjoint, and matches the unsharded Stencil."""
    from pyxu_tpu_torch.operator.linop import Stencil
    from pyxu_tpu_torch.parallel import ShardedStencil
    k0, k1, c0, c1 = ASYM
    shape = (97, 130)
    ref = Stencil(shape, [k0, k1], [c0, c1], mode=mode)
    op = ShardedStencil(shape, [k0, k1], [c0, c1], nccl1,
                        shard_axis=shard_axis, mode=mode)
    assert op.kernel_path == "kernel"
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen, dtype=dtype).cuda()
    for name in ("apply", "adjoint"):
        n0 = st.separable_correlate2d.launches
        got = getattr(op, name)(x).to_local()
        assert st.separable_correlate2d.launches - n0 == 1
        want = getattr(ref, name)(x)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_streamed_condatvu_launches_six_stencils_a_band(cuda):
    """Each band step launches the stencil kernel six times (K, K^T, D^T
    twice, D twice); the card's streamed solve matches the CPU's."""
    from pyxu_tpu_torch.parallel import StreamedCondatVu
    H, W, block = 200, 96, 64
    y = np.random.default_rng(5).random((H, W), dtype=np.float32)
    sols = {}
    for dev in ("cpu", cuda):
        slv = StreamedCondatVu(y, _gauss(), lam=0.02, block_rows=block,
                               device=dev)
        n0 = st.separable_correlate2d.launches
        sols[str(dev)] = slv.fit(n_iters=2).solution()
    bands = -(-H // block)
    assert st.separable_correlate2d.launches - n0 == 6 * bands * 2
    want = sols["cpu"]
    assert np.abs(sols[str(cuda)] - want).max() <= \
        5e-6 * max(1.0, np.abs(want).max())


@pytest.mark.cuda
def test_streamed_map_overlap_and_block_diag_on_the_card(cuda):
    """Both streamed functions with one band in flight (two page-locked
    slots a name, copies on side streams): a batched Stencil band by band
    (one launch a band; 10 bands, the last one short, so each slot is
    reused four times) and 9 blocks of two shapes, each the same bits as
    a serial loop on the card, in two calls, and the CPU's result."""
    from pyxu_tpu_torch.operator.linop import Stencil
    from pyxu_tpu_torch.operator.linop.base import HomothetyOp
    from pyxu_tpu_torch.parallel import (streamed_block_diag,
                                         streamed_map_overlap)
    H, W, block, depth = 600, 96, 64, 4
    x = np.random.default_rng(7).random((2, H, W), dtype=np.float32)
    K = Stencil((block + 2 * depth, W), [_gauss(), _gauss()], [4, 4],
                mode="constant")
    serial = np.zeros_like(x)
    for s in range(0, H, block):        # fill the halo, apply, trim
        e = min(s + block, H)
        band = np.zeros((2, block + 2 * depth, W), np.float32)
        a, b = max(s - depth, 0), min(e + depth, H)
        band[:, a - (s - depth):a - (s - depth) + b - a] = x[:, a:b]
        y = K.apply(torch.from_numpy(band).to(cuda))
        serial[:, s:e] = y[:, depth:depth + e - s].cpu().numpy()
    bands = -(-H // block)
    assert bands >= 8
    for _ in range(2):
        n0 = st.separable_correlate2d.launches
        got = streamed_map_overlap(K.apply, x, depth=depth,
                                   block_rows=block, device=cuda)
        assert st.separable_correlate2d.launches - n0 == bands
        np.testing.assert_array_equal(got, serial)
    want = streamed_map_overlap(K.apply, x, depth=depth, block_rows=block,
                                device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    rng = np.random.default_rng(8)
    shapes = [(H, W), (96, 130)] * 4 + [(96, 130)]
    xs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    ops = [HomothetyOp(dim_shape=sh, cst=0.5 + i)
           for i, sh in enumerate(shapes)]
    serial = [op.apply(torch.from_numpy(xb).to(cuda)).cpu().numpy()
              for op, xb in zip(ops, xs)]
    for _ in range(2):
        ys = streamed_block_diag(ops, xs, device=cuda)
        for yb, sb in zip(ys, serial, strict=True):
            assert isinstance(yb, np.ndarray)
            np.testing.assert_array_equal(yb, sb)
    assert not any(np.shares_memory(ys[i], ys[j])
                   for i in range(len(ys)) for j in range(i))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_sharded_nufft_launches(nccl1, d):
    """ShardedNUFFT at world size 1: one spread an apply, one interp an
    adjoint, the unsharded operator's numbers."""
    from pyxu_tpu_torch.operator.linop.nufft import NUFFT
    from pyxu_tpu_torch.parallel import ShardedNUFFT
    rng = np.random.default_rng(6)
    N = (24, 20) if d == 2 else (12, 10, 8)
    x = rng.uniform(-np.pi, np.pi, (3001, d))
    op = ShardedNUFFT(x, N, nccl1, dtype=torch.float32)
    ref = NUFFT.type1(x, N, dtype=torch.float32, device="cuda")
    assert op.kernel_path == "kernel"
    spread, interp = (nu.nufft_spread2, nu.nufft_interp2) if d == 2 else \
        (nu.nufft_spread3, nu.nufft_interp3)
    a = torch.from_numpy(rng.standard_normal((3001, 2)).astype(
        np.float32)).cuda()
    f = torch.from_numpy(rng.standard_normal(N + (2,)).astype(
        np.float32)).cuda()
    for name, arg, kern in (("apply", a, spread), ("adjoint", f, interp)):
        n0 = kern.launches
        got = getattr(op, name)(arg).to_local()
        assert kern.launches - n0 == 1
        want = getattr(ref, name)(arg)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_sharded_nufft3_launches(nccl1):
    """ShardedNUFFT3 at world size 1 with Q z-blocks: Q spreads and Q
    interps an apply; the result matches a float64 direct sum within
    1e-4 of its largest magnitude (eps 1e-6 at f32)."""
    from pyxu_tpu_torch.operator.linop.nufft import nudft3
    from pyxu_tpu_torch.parallel import ShardedNUFFT3
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.5, 1.5, (2000, 3))
    z = rng.uniform(-20, 20, (1500, 3))
    op = ShardedNUFFT3(x, z, nccl1, fft_mem_mb=0.05, dtype=torch.float32)
    Q = op.stats()["n_z_blocks"]
    assert Q > 1 and op.kernel_path == "kernel"
    a = torch.from_numpy(rng.standard_normal((2000, 2)).astype(np.float32))
    s0, i0 = nu.nufft_spread3.launches, nu.nufft_interp3.launches
    got = op.apply(a.cuda()).to_local()
    assert (nu.nufft_spread3.launches - s0, nu.nufft_interp3.launches - i0) \
        == (Q, Q)
    c = a.double().numpy()
    want = nudft3(c[:, 0] + 1j * c[:, 1], x, z)
    err = np.abs(got.cpu().double().numpy() @ np.array([1, 1j]) - want)
    assert err.max() <= 1e-4 * np.abs(want).max()
