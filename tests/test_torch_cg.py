"""The port's CG solver (operator form) against pyxu_tpu's, on the CPU.

One numpy problem goes through both packages.  Iterates agree within
``atol_for`` (2e-4 at f32, 1e-8 at f64): a dense positive-definite
operator with batched right-hand sides and a residual refresh, and the
3-D Tikhonov problem ``(A^H A + lam I) x = A^H y`` over the 3-D type-2
NUFFT's Toeplitz gram, carried across by ``convert.nufft3_problem``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

from pyxu_tpu.abc.operator import LinOp as JLinOp
from pyxu_tpu.operator.linop import IdentityOp as JIdentityOp
from pyxu_tpu.operator.linop.nufft import NUFFT as JNUFFT
from pyxu_tpu.opt.solver import CG as JCG
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.abc.operator import PosDefOp
from pyxu_tpu_torch.convert import nufft3_problem
from pyxu_tpu_torch.opt.solver import CG
from pyxu_tpu_torch.opt.stop import MaxIter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dense(PosDefOp):
    """x -> A x for a symmetric positive-definite matrix A."""

    def __init__(self, A):
        super().__init__((A.shape[0],))
        self._mat = torch.from_numpy(A)

    def apply(self, arr):
        return arr @ self._mat

    def adjoint(self, arr):
        return self.apply(arr)


def _spd(fdtype, n=24, seed=6):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    A = (B @ B.T / n + 0.3 * np.eye(n)).astype(fdtype)
    b = rng.standard_normal((3, n)).astype(fdtype)
    return A, b


@pytest.mark.parametrize("restart_rate", [None, 4])
def test_cg_matches_jax(restart_rate, fdtype):
    """Right-hand sides (3, 24), x0 given, 9 iterations in segments of 3
    (short of convergence, where float32 rounding would rule): the
    iterate, the residual and the objective."""
    A, b = _spd(fdtype)
    x0 = np.full(A.shape[0], 0.1, fdtype)
    js = JCG(JLinOp.from_array(jnp.asarray(A)), stop_rate=3)
    js.fit(b=jnp.asarray(b), x0=jnp.asarray(x0), restart_rate=restart_rate,
           stop_crit=JMaxIter(9))
    ts = CG(_Dense(A), stop_rate=3)
    ts.fit(b=torch.from_numpy(b), x0=torch.from_numpy(x0),
           restart_rate=restart_rate, stop_crit=MaxIter(9))
    jm, tm = js._mstate, ts._mstate
    assert tm["k"] == int(jm["k"]) == 9
    for name in ("x", "r"):
        assert tm[name].dtype == torch.from_numpy(b).dtype
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=0, atol=atol_for(fdtype))
    np.testing.assert_allclose(float(ts.objective_func(tm)),
                               float(js.objective_func(jm)), rtol=1e-3)


def test_cg_default_stop_and_no_host_read(monkeypatch):
    """The default stop (AbsError 1e-4 on the residual) ends both solves at
    the same iteration with the same x; a step, a refresh step included,
    reads nothing back to the host."""
    A, b = _spd(np.float64)
    js = JCG(JLinOp.from_array(jnp.asarray(A)))
    js.fit(b=jnp.asarray(b), restart_rate=3)
    ts = CG(_Dense(A))
    ts.fit(b=torch.from_numpy(b), restart_rate=3)
    assert ts._mstate["k"] == int(js._mstate["k"])
    assert float(ts.objective_func(ts._mstate)) <= 1e-4 * np.sqrt(3)
    np.testing.assert_allclose(ts.solution().numpy(),
                               np.asarray(js.solution()), rtol=0, atol=1e-8)

    def read(*_):
        raise AssertionError("host read")
    state = ts.m_init(b=torch.from_numpy(b), restart_rate=2)
    for name in ("__bool__", "__float__", "__int__", "item", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)
    for _ in range(3):
        state = ts.m_step(state)
    monkeypatch.undo()
    assert state["k"] == 3


def test_cg_3d_tikhonov_matches_jax(fdtype):
    """``CG(A.gram() + lam I).fit(b=A^H y)`` with A the 3-D type-2 NUFFT
    at 12 x 14 x 10, 20 iterations."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-np.pi, np.pi, (1500, 3))
    y = rng.standard_normal((1500, 2)).astype(fdtype)
    N, lam = (12, 14, 10), 0.5
    A = JNUFFT.type2(x, N, eps=1e-6)
    G = A.gram()
    js = JCG(G + lam * JIdentityOp(G.dim_shape))
    js.fit(b=A.adjoint(jnp.asarray(y)), stop_crit=JMaxIter(20))
    ts, fit = nufft3_problem(x, y, N, lam, device="cpu")
    assert type(ts._A).__name__ == type(js._A).__name__
    ts.fit(stop_crit=MaxIter(20), **fit)
    got = ts.solution().numpy()
    assert got.dtype == fdtype and got.shape == N + (2,)
    np.testing.assert_allclose(got, np.asarray(js.solution()), rtol=0,
                               atol=atol_for(fdtype))


def test_cg_host_array_goes_to_the_card(monkeypatch):
    """A tensor ``b`` runs on its device; a host array goes to ``device``,
    by default ``cuda``, which must exist: with no GPU it raises."""
    A, b = _spd(np.float64)
    slv = CG(_Dense(A))
    slv.fit(b=b, device="cpu", stop_crit=MaxIter(2))
    assert slv.solution().device.type == "cpu"
    slv.fit(b=torch.from_numpy(b), stop_crit=MaxIter(2))
    assert slv.solution().device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slv.fit(b=b, stop_crit=MaxIter(2))
