"""The port's samplers and online statistics against pyxu_tpu's, on the CPU.

JAX's keys and torch's generators never draw the same numbers, so the
chains are compared with the noise fed: the JAX package's key tree is
reproduced (``key, sub = split(key)`` then ``normal(sub, ...)`` for
``samples()``; ``split(key, burn_in + n)`` and ``split(k, thin)`` for
``run``) and each ``w`` goes to the port's deterministic ``_update``.  The
port's own chain (its generator) is held to ULA's exact stationary
variance.  The 64x48 MYULA posterior and Tikhonov ``pinv`` are the card
path's small forms (``chip_smoke.py`` phase 14).  Tolerance: ``atol_for``
times the largest magnitude (at least 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for

import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.sampler as jsam
import pyxu_tpu_torch.operator.func as tfunc
import pyxu_tpu_torch.sampler as tsam
from pyxu_tpu.models.workloads import _blur_op as j_blur
from pyxu_tpu_torch.models.workloads import _blur_op as t_blur

SMALL = (64, 48)
SIGMA, LAM = 0.01, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, fdtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_for(fdtype) * max(
        1.0, float(np.abs(want).max())))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- statistics --

STATS = {
    "moment1": lambda s: s.OnlineMoment(1),
    "moment3": lambda s: s.OnlineMoment(3),
    "centered3": lambda s: s.OnlineCenteredMoment(3),
    "variance": lambda s: s.OnlineVariance(),
    "std": lambda s: s.OnlineStd(),
    "skewness": lambda s: s.OnlineSkewness(),
    "kurtosis": lambda s: s.OnlineKurtosis(),
    "algebra": lambda s: (s.OnlineMoment(2) - s.OnlineMoment(1) ** 2) * 2.0
    + s.OnlineStd() / (s.OnlineMoment(1) + 10.0),
}


def _two_pass(name, X):
    """Each statistic from the whole stack, in float64."""
    m = X.mean(0)
    c = lambda k: ((X - m) ** k).mean(0)     # noqa: E731
    return {"moment1": m, "moment3": (X ** 3).mean(0), "centered3": c(3),
            "variance": c(2), "std": np.sqrt(c(2)),
            "skewness": c(3) / c(2) ** 1.5, "kurtosis": c(4) / c(2) ** 2,
            "algebra": ((X ** 2).mean(0) - m ** 2) * 2.0
            + np.sqrt(c(2)) / (m + 10.0)}[name]


@pytest.mark.parametrize("name,fdtype", [
    (n, np.dtype(np.float32 if i % 2 == 0 else np.float64))
    for i, n in enumerate(sorted(STATS))])
def test_online_statistics_match_jax(name, fdtype, rng):
    X = (rng.standard_normal((200, 3, 4)) * 2 + 1).astype(fdtype)
    J, T = STATS[name](jsam), STATS[name](tsam)
    for i, x in enumerate(X):
        got = T.update(_t(x))
        want = J.update(jnp.asarray(x))
        if i in (0, 1, 57):
            _close(got, want, fdtype)
    assert got.dtype == _t(X[0]).dtype and got.device.type == "cpu"
    _close(T.stat(), J.stat(), fdtype)
    _close(T.stat(), _two_pass(name, X.astype(np.float64)), fdtype)


def test_statistics_before_update_raise():
    with pytest.raises(RuntimeError):
        tsam.OnlineMoment().stat()
    with pytest.raises(RuntimeError):
        tsam.OnlineVariance().stat()


# -------------------------------------------------------------- the chains --

def _posterior(pkg, shape=SMALL, seed=0):
    """MYULA's deblurring posterior (chip_smoke.py phase 14 at ``shape``):
    workload 1's sparse image and its 9-tap sigma = 2 blur (the factories'
    own), 1% noise."""
    rng = np.random.default_rng(seed)
    x_true = (rng.random(shape) < 0.01).astype(np.float32)
    n = rng.standard_normal(shape).astype(np.float32)
    if pkg == "jax":
        K = j_blur(shape)
        y = jax.jit(K.apply)(jnp.asarray(x_true)) + SIGMA * jnp.asarray(n)
        func = jfunc
    else:
        K = t_blur(shape)
        y = K.apply(_t(x_true)) + SIGMA * _t(n)
        func = tfunc
    f = (0.5 / SIGMA ** 2) * func.SquaredL2Norm(shape).asloss(y) * K
    g = (LAM / SIGMA ** 2) * func.L1Norm(shape)
    return f, g, K, y


def _samples_noise(seed, n, shape, dtype):
    """The noise of the JAX package's ``samples()``: one split a step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype)))
    return out


def _fed_chain(sampler, x0, ws):
    x, out = x0, []
    for w in ws:
        x = sampler._update(x, _t(w))
        out.append(x)
    return out


def test_myula_64x48_matches_jax_sample_by_sample():
    fj, gj, _, _ = _posterior("jax")
    ft, gt, _, _ = _posterior("torch")
    J, T = jsam.MYULA(fj, gj), tsam.MYULA(ft, gt)
    # the Stencil's declared bound sets beta_f: no random estimate
    assert T.lamb == J._lamb and T.gamma == J.gamma
    assert ft.diff_lipschitz == fj.diff_lipschitz
    steps = 11
    ws = _samples_noise(3, steps, SMALL, np.float32)
    chain = J.samples(jnp.zeros(SMALL, jnp.float32), seed=3)
    mine = _fed_chain(T, torch.zeros(SMALL), ws)
    for i in range(steps):
        want = next(chain)
        if i % 5 == 0:
            _close(mine[i], want, np.float32)
    # the objective and the drift: f plus g's Moreau envelope
    x = mine[-1]
    env = gt.moreau_envelope(T.lamb)
    _close(T.objective_func(x), ft.apply(x) + env.apply(x), np.float32)
    drift = T._drift(x)
    want = ft.grad(x) + env.grad(x)
    assert float((drift - want).abs().max()) <= 1e-6 * float(
        want.abs().max())


def test_ula_and_run_schedule_match_jax(rng):
    fdtype = np.dtype(np.float64)           # the MYULA test runs f32
    A = rng.standard_normal((5, 4)).astype(fdtype) / 2
    y = rng.standard_normal(5).astype(fdtype)
    import pyxu_tpu.abc as jabc
    import pyxu_tpu_torch.abc as tabc
    fj = jfunc.SquaredL2Norm((5,)).asloss(jnp.asarray(y)) * \
        jabc.LinOp.from_array(jnp.asarray(A))
    ft = tfunc.SquaredL2Norm((5,)).asloss(_t(y)) * \
        tabc.LinOp.from_array(_t(A))
    J, T = jsam.ULA(fj, gamma=0.05), tsam.ULA(ft, gamma=0.05)
    x0 = rng.standard_normal(4).astype(fdtype)
    ws = _samples_noise(1, 12, (4,), fdtype)
    chain = J.samples(jnp.asarray(x0), seed=1)
    for got in _fed_chain(T, _t(x0), ws):
        _close(got, next(chain), fdtype)
    # run: burn_in + n draws of thin steps each, keys split as in the JAX
    # package; the port's run fed those draws through its _step
    n, thin, burn_in, seed = 4, 2, 3, 5
    keys = jax.random.split(jax.random.PRNGKey(seed), burn_in + n)
    draws = iter([np.asarray(jax.random.normal(s, (4,), fdtype))
                  for k in keys for s in jax.random.split(k, thin)])
    T._step = lambda x, gen: T._update(x, _t(next(draws)))
    got = T.run(_t(x0), n=n, seed=seed, thin=thin, burn_in=burn_in)
    want = J.run(jnp.asarray(x0), n=n, seed=seed, thin=thin, burn_in=burn_in)
    assert tuple(got.shape) == tuple(want.shape) == (n, 4)
    _close(got, want, fdtype)


@pytest.mark.parametrize("gamma", [None, 0.25])
def test_ula_chain_has_the_exact_stationary_variance(gamma):
    """F = ||x||^2 gives x+ = (1 - 2 g) x + sqrt(2 g) w, whose stationary
    variance is 1 / (2 (1 - g)); 2000 independent coordinates, 300 draws
    after 40 burn-in steps."""
    F = tfunc.SquaredL2Norm((2000,))
    U = tsam.ULA(F, gamma=gamma)
    assert U.gamma == pytest.approx(0.98 / 2 if gamma is None else gamma)
    var = tsam.OnlineVariance()
    it = U.samples(torch.zeros(2000, dtype=torch.float64), seed=7)
    for i in range(340):
        x = next(it)
        if i >= 40:
            var.update(x)
    want = 1.0 / (2.0 * (1.0 - U.gamma))
    assert float(var.stat().mean()) == pytest.approx(want, rel=0.02)


def test_chain_is_deterministic_and_stays_on_its_device(monkeypatch):
    F = tfunc.SquaredL2Norm((3, 4))
    g = tfunc.L1Norm((3, 4))
    M = tsam.MYULA(F, g)
    a = M.run(torch.zeros(3, 4), n=5, seed=11, thin=2)
    b = M.run(torch.zeros(3, 4), n=5, seed=11, thin=2)
    c = M.run(torch.zeros(3, 4), n=5, seed=12, thin=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    it = M.samples(torch.zeros(3, 4, dtype=torch.float64), seed=11)
    assert next(it).dtype == torch.float64
    # f = None is the constant 0: lamb 2, gamma 0.98 / 0.5
    G = tsam.MYULA(g=g)
    assert G.lamb == 2.0 and G.gamma == pytest.approx(0.98 / 0.5)
    # a host array goes to the card, which must exist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(M.samples(np.zeros((3, 4), np.float32)))


def test_pinv_64x48_matches_jax():
    """Tikhonov deblurring: K.pinv(y, damp=1e-2), the dagger's bits, the
    normal-equation residual."""
    _, _, Kj, yj = _posterior("jax")
    _, _, Kt, yt = _posterior("torch")
    want = jax.jit(lambda v: Kj.pinv(v, damp=1e-2))(yj)
    got = Kt.pinv(yt, damp=1e-2)
    _close(got, want, np.float32)
    assert torch.equal(Kt.dagger(1e-2).apply(yt), got)
    b = Kt.adjoint(yt)
    res = Kt.adjoint(Kt.apply(got)) + 1e-2 * got - b
    rtol = max(100 * float(torch.finfo(torch.float32).eps), 1e-6)
    assert float(res.norm() / b.norm()) <= 2 * rtol
