"""The port's out-of-core streaming against pyxu_tpu's, on the CPU.

``streamed_map_overlap``, ``streamed_block_diag`` and ``StreamedCondatVu``
take one numpy input in both packages.  The streamed TV solve is also held
against the in-memory Condat-Vu iteration written from the port's public
``Stencil``, ``Gradient`` and ``L21Norm`` (5e-6 of max(1, max|x|): the
band step is the global iteration, not block-Jacobi), and a memmap-backed
state against an in-memory one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.parallel as jpar
from pyxu_tpu.operator.linop import Stencil as JStencil
from pyxu_tpu.operator.linop.base import HomothetyOp as JHomothety
from pyxu_tpu_torch.operator.func import L21Norm
from pyxu_tpu_torch.operator.linop import Gradient, Stencil
from pyxu_tpu_torch.operator.linop.base import HomothetyOp
from pyxu_tpu_torch.parallel import (StreamedCondatVu, streamed_block_diag,
                                     streamed_map_overlap)

TOL = atol_for(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss1d(sigma, n):
    t = np.arange(n) - (n - 1) / 2
    k = np.exp(-0.5 * (t / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("block_rows", [16, 37, 200])
def test_streamed_map_overlap_matches(block_rows):
    """Band-streamed stencil apply == one global apply (mode=constant), and
    == the JAX package's streamed apply."""
    H, W = 120, 33
    x = np.random.default_rng(block_rows).standard_normal((H, W)) \
        .astype(np.float32)
    k1 = _gauss1d(1.5, 7)
    want = Stencil((H, W), [k1, k1], [3, 3], mode="constant").apply(
        torch.from_numpy(x)).numpy()
    Rh = min(block_rows, H) + 2 * 4
    Kb = Stencil((Rh, W), [k1, k1], [3, 3], mode="constant")
    got = streamed_map_overlap(Kb.apply, x, depth=4, block_rows=block_rows,
                               device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want, 1e-6)
    jKb = JStencil((Rh, W), [jnp.asarray(k1)] * 2, [3, 3], mode="constant")
    _close(got, jpar.streamed_map_overlap(jKb.apply, x, depth=4,
                                          block_rows=block_rows), TOL)


def test_streamed_map_overlap_batch_axes():
    x = np.random.default_rng(2).standard_normal((3, 40, 17)) \
        .astype(np.float32)
    got = streamed_map_overlap(lambda b: 2.0 * b, x, depth=2, block_rows=16,
                               device="cpu")
    np.testing.assert_array_equal(got, 2.0 * x)
    f64 = streamed_map_overlap(lambda b: b, x, depth=2, block_rows=16,
                               out_dtype=np.float64, device="cpu")
    assert f64.dtype == np.float64


def test_streamed_block_diag_matches():
    cs = (1.0, -2.0, 0.5)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((8, 5)).astype(np.float32) for _ in cs]
    ys = streamed_block_diag([HomothetyOp(dim_shape=(8, 5), cst=c)
                              for c in cs], xs, device="cpu")
    jys = jpar.streamed_block_diag([JHomothety(dim_shape=(8, 5), cst=c)
                                    for c in cs], xs)
    for c, xb, yb, jb in zip(cs, xs, ys, jys):
        assert isinstance(yb, np.ndarray)
        np.testing.assert_allclose(yb, c * xb, atol=1e-6)
        _close(yb, jb, TOL)
    with pytest.raises(ValueError, match="ops vs"):
        streamed_block_diag([HomothetyOp(dim_shape=(8, 5), cst=1.0)], xs,
                            device="cpu")


def _in_memory_cv(y, k1, lam, tau, sigma, n_iters):
    """The global Condat-Vu iteration with the same operators and
    boundary, in memory."""
    H, W = y.shape
    c = (len(k1) - 1) // 2
    K = Stencil((H, W), [k1, k1], [c, c], mode="constant")
    D = Gradient((H, W), mode="constant")
    h = lam * L21Norm((2, H, W), l2_axis=0)
    x = torch.from_numpy(y)
    z = torch.zeros((2, H, W))
    for _ in range(n_iters):
        gf = K.adjoint(K.apply(x) - x.new_tensor(y))
        xp = x - tau * (gf + D.adjoint(z))
        u = D.apply(2.0 * xp - x)
        z = h.fenchel_prox(z + sigma * u, sigma)
        x = xp
    return x.numpy()


def _blurred(H, W, k1, seed=7):
    x_true = np.random.default_rng(seed).random((H, W), dtype=np.float32)
    c = (len(k1) - 1) // 2
    return Stencil((H, W), [k1, k1], [c, c], mode="constant").apply(
        torch.from_numpy(x_true)).numpy()


@pytest.mark.parametrize("block_rows", [24, 50])
def test_streamed_condatvu_matches(block_rows):
    """The streamed solve is the global iteration: it matches the in-memory
    solver to f32 reassociation, and the JAX package's streamed solve."""
    H, W = 96, 41
    k1 = _gauss1d(2.0, 9)
    y = _blurred(H, W, k1)
    slv = StreamedCondatVu(y, k1, lam=0.02, block_rows=block_rows,
                           device="cpu")
    slv.fit(n_iters=6)
    want = _in_memory_cv(y, k1, 0.02, slv._tau, slv._sigma, 6)
    err = np.abs(slv.solution() - want).max()
    assert err < 5e-6 * max(1.0, np.abs(want).max()), err
    jslv = jpar.StreamedCondatVu(y, k1, lam=0.02, block_rows=block_rows)
    jslv.fit(n_iters=6)
    assert (slv._tau, slv._sigma, slv._halo, slv._block) == \
        (jslv._tau, jslv._sigma, jslv._halo, jslv._block)
    _close(slv.solution(), jslv.solution(), TOL)
    _close(slv._z, jslv._z, TOL)


def test_streamed_condatvu_memmap_state(tmp_path):
    """Disk-backed y (np.memmap) streams as an in-memory y does."""
    H, W = 64, 33
    k1 = _gauss1d(1.5, 7)
    y = np.random.default_rng(3).random((H, W), dtype=np.float32)
    p = tmp_path / "y.dat"
    mm = np.memmap(p, dtype=np.float32, mode="w+", shape=(H, W))
    mm[:] = y
    mm.flush()
    slv_mm = StreamedCondatVu(np.memmap(p, dtype=np.float32, mode="r",
                                        shape=(H, W)), k1, lam=0.02,
                              block_rows=16, device="cpu")
    slv = StreamedCondatVu(y, k1, lam=0.02, block_rows=16, device="cpu")
    slv_mm.fit(n_iters=4)
    slv.fit(n_iters=4)
    np.testing.assert_array_equal(slv_mm.solution(), slv.solution())


def test_streamed_condatvu_accounting():
    """``state_bytes`` is x, z and y; ``bytes_moved`` is each band's x, z, y
    and mask up and its core rows of x and z down, an iteration."""
    H, W, block = 50, 20, 16
    k1 = _gauss1d(1.0, 3)
    slv = StreamedCondatVu(np.ones((H, W), np.float32), k1, block_rows=block,
                           device="cpu")
    assert slv.state_bytes == 4 * H * W * 4
    slv.fit(n_iters=2)
    Rh = block + 2 * slv._halo
    bands = -(-H // block)
    up = bands * (4 * Rh * W + 4 * 2 * Rh * W + 4 * Rh * W + 4 * Rh)
    down = 4 * H * W * 3
    assert slv.bytes_moved == 2 * (up + down)
    with pytest.raises(ValueError, match="odd-length"):
        StreamedCondatVu(np.ones((8, 8), np.float32), np.ones(4),
                         device="cpu")


def _serial_map_overlap(fn, x, depth, block_rows):
    """The band loop in series, written out: fill each band's halo (zeros
    outside the domain and past the band's end), apply, trim."""
    n = x.shape[-2]
    block = min(block_rows, n)
    out = None
    for s in range(0, n, block):
        e = min(s + block, n)
        band = np.zeros(x.shape[:-2] + (block + 2 * depth, x.shape[-1]),
                        x.dtype)
        a, b = max(s - depth, 0), min(e + depth, n)
        band[..., a - (s - depth):a - (s - depth) + b - a, :] = \
            x[..., a:b, :]
        rows = fn(torch.from_numpy(band)).numpy()[..., depth:depth + e - s, :]
        if out is None:
            out = np.zeros(rows.shape[:-2] + (n,) + rows.shape[-1:],
                           rows.dtype)
        out[..., s:e, :] = rows
    return out


@pytest.mark.parametrize("block_rows", [8, 13])
def test_streamed_map_overlap_batch_and_short_band_bits(block_rows):
    """Leading batch axes and a last band shorter than ``block_rows``
    (50 rows): the same bits as the serial loop, and the JAX package's
    streamed apply within the f32 tolerance."""
    H, W = 50, 19
    x = np.random.default_rng(block_rows).standard_normal((2, 3, H, W)) \
        .astype(np.float32)
    assert H % block_rows
    k1 = _gauss1d(1.2, 5)
    Kb = Stencil((block_rows + 6, W), [k1, k1], [2, 2], mode="constant")
    got = streamed_map_overlap(Kb.apply, x, depth=3, block_rows=block_rows,
                               device="cpu")
    np.testing.assert_array_equal(
        got, _serial_map_overlap(Kb.apply, x, 3, block_rows))
    jKb = JStencil((block_rows + 6, W), [jnp.asarray(k1)] * 2, [2, 2],
                   mode="constant")
    _close(got, jpar.streamed_map_overlap(jKb.apply, x, depth=3,
                                          block_rows=block_rows), TOL)


def test_streamed_block_diag_two_shapes_bits():
    """Blocks of two shapes, interleaved (the staging slots are keyed by
    shape): the same bits as applying each operator alone, and the JAX
    package's blocks."""
    rng = np.random.default_rng(4)
    shapes = [(8, 5), (6, 7), (8, 5), (6, 7), (6, 7)]
    cs = [1.5, -0.5, 2.0, 3.0, 0.25]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ops = [HomothetyOp(dim_shape=s, cst=c) for s, c in zip(shapes, cs)]
    ys = streamed_block_diag(ops, xs, device="cpu")
    jys = jpar.streamed_block_diag(
        [JHomothety(dim_shape=s, cst=c) for s, c in zip(shapes, cs)], xs)
    for op, xb, yb, jb in zip(ops, xs, ys, jys, strict=True):
        assert yb.shape == xb.shape
        np.testing.assert_array_equal(
            yb, op.apply(torch.from_numpy(xb)).numpy())
        _close(yb, jb, TOL)
