"""The port's FFT operator against pyxu_tpu's, on the CPU.

One numpy input goes through ``pyxu_tpu.operator.linop.FFT`` (its own
jitted dispatch) and ``pyxu_tpu_torch.operator.linop.FFT``: apply,
adjoint, gram, cogram, pinv, dagger and svdvals, over ``axes`` and
``real``, batched, at float32 and float64, within ``atol_for`` times the
output's largest magnitude (an unnormalised DFT grows as N).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu_torch.abc.operator import _GramOp
from pyxu_tpu_torch.operator.linop.base import HomothetyOp

# spatial shape, axes, real
CASES = [((8, 4), None, False), ((6,), None, True), ((4, 6), (1,), False),
         ((3, 4, 5), (0, -1), True), ((5, 6), 0, False)]
BATCH = (2, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, fdtype):
    want = np.asarray(want)
    tol = atol_for(fdtype) * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def _ops(shape, axes, real):
    return (jlin.FFT(shape, axes=axes, real=real),
            tlin.FFT(shape, axes=axes, real=real))


def _input(op, rng, fdtype, batch=BATCH, co=False):
    shape = batch + (op.codim_shape if co else op.dim_shape)
    return rng.standard_normal(shape).astype(fdtype)


@pytest.mark.parametrize("shape,axes,real", CASES)
def test_apply_adjoint_match_jax(shape, axes, real, fdtype, rng):
    J, T = _ops(shape, axes, real)
    assert T.dim_shape == J.dim_shape and T.codim_shape == J.codim_shape
    assert T._axes == J._axes and T._N == J._N
    x = _input(T, rng, fdtype)
    y = _input(T, rng, fdtype, co=True)
    got = T.apply(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got, J.apply(jnp.asarray(x)), fdtype)
    _close(T.adjoint(torch.from_numpy(y)), J.adjoint(jnp.asarray(y)), fdtype)
    # the adjoint identity <Ax, y> = <x, A^* y>
    lhs = float((got * torch.from_numpy(y)).sum())
    rhs = float((torch.from_numpy(x) * T.adjoint(torch.from_numpy(y))).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)) * (
        1 if fdtype == np.float32 else 1e-6)


@pytest.mark.parametrize("shape,axes,real", CASES)
def test_gram_cogram_pinv_dagger(shape, axes, real, fdtype, rng):
    J, T = _ops(shape, axes, real)
    x = _input(T, rng, fdtype, batch=(2,))
    y = _input(T, rng, fdtype, batch=(2,), co=True)
    G = T.gram()
    assert isinstance(G, HomothetyOp) and G._cst == J.gram()._cst == T._N
    _close(G.apply(torch.from_numpy(x)), J.gram().apply(jnp.asarray(x)),
           fdtype)
    C, CJ = T.cogram(), J.cogram()
    if real:
        assert isinstance(C, _GramOp)
    else:
        assert isinstance(C, HomothetyOp) and C._cst == T._N
    _close(C.apply(torch.from_numpy(y)), CJ.apply(jnp.asarray(y)), fdtype)
    for damp in (0.0, 1.5):
        _close(T.pinv(torch.from_numpy(y), damp=damp),
               J.pinv(jnp.asarray(y), damp=damp), fdtype)
        D, DJ = T.dagger(damp=damp), J.dagger(damp=damp)
        assert D.dim_shape == T.codim_shape and D.codim_shape == T.dim_shape
        _close(D.apply(torch.from_numpy(y)), DJ.apply(jnp.asarray(y)), fdtype)
        # the pseudo-inverse undoes A: A^+ A x = N / (N + damp) x
        _close(T.pinv(T.apply(torch.from_numpy(x)), damp=damp),
               T._N / (T._N + damp) * x, fdtype)


@pytest.mark.parametrize("shape,axes,real", CASES)
def test_lipschitz_and_svdvals(shape, axes, real):
    J, T = _ops(shape, axes, real)
    assert T.lipschitz == pytest.approx(J.lipschitz, rel=1e-12)
    assert T.estimate_lipschitz() == pytest.approx(np.sqrt(T._N), rel=1e-12)
    for dt in (torch.float32, torch.float64):
        s = T.svdvals(k=3, dtype=dt, device="cpu")
        assert s.dtype == dt and s.device.type == "cpu"
        np.testing.assert_allclose(s.numpy(), np.asarray(J.svdvals(k=3)),
                                   rtol=1e-6)


def test_fft_matches_numpy_and_refuses_aliased_axes(rng):
    T = tlin.FFT((8, 4))
    z = rng.standard_normal((8, 4)) + 1j * rng.standard_normal((8, 4))
    got = torch.view_as_complex(T.apply(torch.view_as_real(
        torch.from_numpy(z))))
    np.testing.assert_allclose(got.numpy(), np.fft.fftn(z), atol=1e-10)
    x = np.cos(2 * np.pi / 10 * np.arange(10))
    y = torch.view_as_complex(tlin.FFT((10,), real=True).apply(
        torch.from_numpy(x))).numpy()
    want = np.zeros(10, complex)
    want[1] = want[-1] = 5
    np.testing.assert_allclose(y, want, atol=1e-12)
    with pytest.raises(ValueError, match="aliased"):
        tlin.FFT((4, 6), axes=(1, -1))
