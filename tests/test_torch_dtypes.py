"""Input-dtype parity of the port with the JAX package, on the CPU.

One numpy input, rounded to the case's dtype (bfloat16, float16, float32
or float64), goes through an operator of each family of both packages
(the JAX side under one ``jax.jit`` a family and dtype, x64 on as
``tests/conftest.py`` sets it), apply and adjoint.  Each case asserts the
JAX package's result dtype exactly.  Then, by family:

* **widening** (the NUFFT types 1, 2 and 3 at d = 1, 2, 3, the chunked
  type 3, the type-1 gram, the type-2 Toeplitz gram, FourierRadon and its
  gram, FFT): the result is ``promote(dtype, float32)``, and its values
  lie within ``atol_for`` (2e-4 at float32, 1e-8 at float64) times
  ``max(1, max|y|)`` of the JAX package's.  The ``plan64`` families build
  the port's plan in float64: a float32 or narrower input runs on a float32
  plan built from the same float64 points;
* **narrow storage** (Stencil on and off the kernel path, Gaussian,
  Gradient, RadonTransform, Pad): a bfloat16 or float16 input keeps its
  dtype.  The port computes in float32 and rounds once: it lies within
  ``eps(dtype) max|y32|`` of its own float32 result ``y32`` on the same
  rounded input (the output's rounding, and on the kernel path the taps'
  rounding to the storage type).  The JAX package rounds after each tap
  sum, so its result is held to the wider ``4 eps(dtype) max|y32|``
  (measured: 1.1e-2 at bfloat16 and 1.4e-3 at float16 of max|y| for a
  9-tap Gaussian at 64x64).  At float32 and float64 the values are held
  to ``atol_for``;
* **the conformance operators** (``tests/test_torch_conformance.py``'s
  ``OPS``, each built at the case's dtype, as the JAX counterpart built
  from the same rounded data): the dtype, which ``jax.eval_shape``
  gives.  A quadratic's value widens a narrower input: the JAX package
  holds its constant ``t`` as a float32 0-d array.

Two fits follow the JAX package's mixed-precision recipe,
``precision_schedule=[(bf16, 10), (f32, None)]`` for 20 iterations: radio
interferometry at 32x32 (300 visibilities, ADMM over the NUFFT's gram)
and sparse-view Fourier CT at 32x32 (8 views, PD3O over FourierRadon),
each held to 1e-2 of max|x| of the JAX package's solution (for CT, whose
bf16 phase the JAX package drops, its float32 solution).

Torch runs on one thread.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import atol_for
from test_torch_conformance import OPS

import pyxu_tpu.abc as jabc
import pyxu_tpu.operator as jop
import pyxu_tpu.operator.func as jfunc
import pyxu_tpu.operator.linop as jlin
import pyxu_tpu_torch.operator.linop as tlin
from pyxu_tpu.models.workloads import radio_interferometry as jri
from pyxu_tpu.models.workloads import sparse_view_ct as jct
from pyxu_tpu.operator.interop.source import from_source as j_source
from pyxu_tpu.operator.map.base import ConstantValued as JConst
from pyxu_tpu.opt.stop import MaxIter as JMaxIter
from pyxu_tpu_torch.models import radio_interferometry, sparse_view_ct
from pyxu_tpu_torch.ops import nufft as nu
from pyxu_tpu_torch.ops import stencil as st
from pyxu_tpu_torch.opt.stop import MaxIter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the arrays here are small, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64)}
_T2J = {t: j for t, j in DTYPES.values()}


def _eps(tdt) -> float:
    return torch.finfo(tdt).eps


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().numpy()


def _rounded(a: np.ndarray, name: str):
    """``a`` rounded to the dtype ``name``: the port's tensor and the JAX
    package's array of the same values."""
    tdt, jdt = DTYPES[name]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(_np(t)).astype(jdt)


def _gauss(L, s):
    t = np.arange(L) - (L - 1) / 2
    k = np.exp(-0.5 * (t / s) ** 2)
    return k / k.sum()


# ------------------------------------------------------------- families --

def _pts(rng, M, d):
    return rng.uniform(-np.pi, np.pi, (M, d))


_N = {1: (16,), 2: (8, 10), 3: (6, 5, 4)}
_M = {1: 40, 2: 60, 3: 50}


def _nufft(kind, d, plan64=False):
    rng = np.random.default_rng(10 + d)
    x = _pts(rng, _M[d], d)
    kw = dict(dtype=torch.float64) if plan64 else {}
    if kind == "t3":
        z = rng.uniform(-8, 8, (30, d))
        return (tlin.NUFFT.type3(x, z, device="cpu", **kw),
                jlin.NUFFT.type3(x, z))
    if kind == "chunked":
        z = rng.uniform(-8, 8, (30, d))
        return (tlin.NUFFT.type3(x, z, chunked=True, fft_mem_mb=0.01,
                                 max_blocks=4, device="cpu", **kw),
                jlin.NUFFT.type3(x, z, chunked=True, fft_mem_mb=0.01,
                                 max_blocks=4))
    make = "type1" if kind in ("t1", "gram1") else "type2"
    A = getattr(tlin.NUFFT, make)(x, _N[d], device="cpu", **kw)
    B = getattr(jlin.NUFFT, make)(x, _N[d])
    if kind in ("gram1", "gram2"):
        return A.gram(), B.gram()
    return A, B


_ANGLES = np.linspace(0, np.pi, 5, endpoint=False)


def _fourier_radon(gram=False, plan64=False):
    kw = dict(dtype=torch.float64) if plan64 else {}
    A = tlin.FourierRadon((12, 10), _ANGLES, eps=1e-9, device="cpu", **kw)
    B = jlin.FourierRadon((12, 10), _ANGLES, eps=1e-9)
    return (A.gram(), B.gram()) if gram else (A, B)


def _fft():
    return tlin.FFT((6, 8)), jlin.FFT((6, 8))


WIDENING = {f"nufft_{k}_d{d}": (lambda k=k, d=d: _nufft(k, d))
            for k in ("t1", "t2", "t3") for d in (1, 2, 3)}
WIDENING.update({
    "nufft_gram1_d2": lambda: _nufft("gram1", 2),
    "nufft_gram2_d2": lambda: _nufft("gram2", 2),
    "nufft_t1_d2_plan64": lambda: _nufft("t1", 2, True),
    "nufft_t2_d2_plan64": lambda: _nufft("t2", 2, True),
    "nufft_t3_d2_plan64": lambda: _nufft("t3", 2, True),
    "nufft_gram2_d2_plan64": lambda: _nufft("gram2", 2, True),
    "fourier_radon": _fourier_radon,
    "fourier_radon_plan64": lambda: _fourier_radon(plan64=True),
    "fourier_radon_gram": lambda: _fourier_radon(gram=True),
    "fft": _fft,
})


def _stencil(mode):
    k0, k1 = _gauss(9, 2.0), _gauss(5, 1.0)
    return (tlin.Stencil((20, 24), [k0, k1], [4, 2], mode=mode),
            jlin.Stencil((20, 24), [jnp.asarray(k0), jnp.asarray(k1)],
                         [4, 2], mode=mode))


def _radon():
    ang = np.linspace(0, np.pi, 6, endpoint=False)
    return (tlin.RadonTransform((12, 10), ang, device="cpu"),
            jlin.RadonTransform((12, 10), ang))


KEEPING = {
    "nufft_chunked_d2": lambda: _nufft("chunked", 2),
    "stencil_kernel": lambda: _stencil("symmetric"),
    "stencil_plain": lambda: _stencil("reflect"),
    "gaussian": lambda: (tlin.Gaussian((20, 24), sigma=1.5, mode="symmetric"),
                         jlin.Gaussian((20, 24), sigma=1.5,
                                       mode="symmetric")),
    "gradient": lambda: (tlin.Gradient((20, 24), mode="symmetric"),
                         jlin.Gradient((20, 24), mode="symmetric")),
    "radon": _radon,
    "pad": lambda: (tlin.Pad((7, 9), ((1, 2), (3, 0)), mode="reflect"),
                    jlin.Pad((7, 9), ((1, 2), (3, 0)), mode="reflect")),
}
FAMILIES = {**WIDENING, **KEEPING}
# the JAX package keeps its FourierRadon detector phase in complex64, which
# holds its float64 transform to ~1e-7 of max|y| (tests/test_torch_xray.py);
# test_fourier_radon_float64_input_is_float64_accurate holds the port's to
# the direct sum
_F64_TOL = {"fourier_radon": 1e-7, "fourier_radon_plan64": 1e-7}
# the JAX package's real-input Toeplitz gram calls jnp.fft.rfftn, which
# refuses 2-byte inputs: there the port's widened result is held to the
# JAX package's float32 result on the same rounded input
JAX_REFUSES = {("fourier_radon_gram", "bf16"), ("fourier_radon_gram", "f16")}
_OPS, _JAX = {}, {}


def _ops(fam):
    if fam not in _OPS:
        _OPS[fam] = FAMILIES[fam]()
    return _OPS[fam]


def _inputs(op, fam):
    rng = np.random.default_rng(zlib.crc32(fam.encode()))
    return (rng.standard_normal(op.dim_shape),
            rng.standard_normal(op.codim_shape))


def _jax_results(fam, name, cast=None):
    """The JAX family's apply and adjoint of the inputs rounded to
    ``name`` (then cast to ``cast``), one jit (the plan64 families share
    their base family's JAX operator)."""
    base = fam.replace("_plan64", "")
    key = (base, name, cast)
    if key not in _JAX:
        top, jop_ = _ops(base)
        xa, xb = _inputs(top, base)
        ja, jb = _rounded(xa, name)[1], _rounded(xb, name)[1]
        if cast is not None:
            ja, jb = ja.astype(cast), jb.astype(cast)
        _JAX[key] = jax.jit(lambda a, b: (jop_.apply(a), jop_.adjoint(b)))(
            ja, jb)
    return _JAX[key]


CASES = [(fam, name, direction) for fam in FAMILIES for name in DTYPES
         for direction in ("apply", "adjoint")]


@pytest.mark.parametrize("fam,name,direction", CASES)
def test_dtype_matches_jax(fam, name, direction):
    base = fam.replace("_plan64", "")
    top = _ops(fam)[0]
    xa, xb = _inputs(_ops(base)[0], base)
    t_in = _rounded(xa if direction == "apply" else xb, name)[0]
    i = 0 if direction == "apply" else 1
    got = getattr(top, direction)(t_in)
    if (fam, name) in JAX_REFUSES:
        with pytest.raises(ValueError, match="RFFT input"):
            _jax_results(fam, name)
        want = _jax_results(fam, name, jnp.float32)[i]
    else:
        want = _jax_results(fam, name)[i]
    assert _T2J[got.dtype] == want.dtype, (got.dtype, want.dtype)
    tdt = DTYPES[name][0]
    w = np.asarray(want.astype(jnp.float64))
    if fam in KEEPING and tdt in st.NARROW:
        y32 = _np(getattr(top, direction)(t_in.float()))
        scale = float(np.abs(y32).max())
        assert float(np.abs(_np(got) - y32).max()) <= _eps(tdt) * scale
        assert float(np.abs(w - y32).max()) <= 4 * _eps(tdt) * scale
        return
    if fam in WIDENING:
        assert got.dtype == nu.compute_dtype(tdt)
    tol = atol_for(np.float64 if got.dtype == torch.float64 else np.float32)
    if got.dtype == torch.float64:
        tol = _F64_TOL.get(fam, tol)
    assert float(np.abs(_np(got) - w).max()) <= tol * max(
        1.0, float(np.abs(w).max()))


def _fourier_slice(img, angles, n_det):
    """FourierRadon's Fourier-slice sum, directly (host float64)."""
    H, W = img.shape
    q = np.fft.fftfreq(n_det) * 2 * np.pi
    ks = np.stack(np.meshgrid(np.arange(-(H // 2), (H + 1) // 2),
                              np.arange(-(W // 2), (W + 1) // 2),
                              indexing="ij"), -1).reshape(-1, 2)
    dirs = np.stack([np.cos(angles), np.sin(angles)], 1)
    phat = np.exp(-1j * q[None, :, None] * (dirs @ ks.T)[:, None, :]) \
        @ img.reshape(-1)
    return np.fft.ifft(phat * np.exp(-1j * q * (n_det - 1) / 2.0)).real


@pytest.mark.parametrize("fam", ["fourier_radon", "fourier_radon_plan64"])
def test_fourier_radon_float64_input_is_float64_accurate(fam):
    """A float64 image through a float32-planned and a float64-planned
    FourierRadon (eps 1e-9): within 1e-8 of max|y| of the direct sum."""
    top = _ops(fam)[0]
    img = _inputs(top, "fourier_radon")[0]
    got = _np(top.apply(torch.from_numpy(img)))
    want = _fourier_slice(img, _ANGLES, top.codim_shape[1])
    assert float(np.abs(got - want).max()) <= 1e-8 * float(
        np.abs(want).max())


# ------------------------------------------------ the conformance operators --

def _jmat(shape, jdt, seed):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape)).astype(jdt)


def _jby_matrix(cls, M):
    return j_source(cls, (M.shape[1],), (M.shape[0],),
                    apply=lambda v: v @ M.T, adjoint=lambda v: v @ M)


def _jqr(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((5, 5)))
    return q


def _jstencils(n, equal=False):
    ks = [np.random.default_rng(0 if equal else 20 + i).uniform(0.1, 1.0, 7)
          for i in range(n)]
    return [jlin.Stencil((6, 7), [jnp.asarray(k[:3]), jnp.asarray(k[3:])],
                         [1, 2], mode="symmetric") for k in ks]


def _jblocks(kind, jdt):
    fam = {
        "diagonal": [jlin.DiagonalOp(jnp.abs(_jmat((3, 4), jdt, 20 + i))
                                     + 0.5) for i in range(3)],
        "explicit": [jlin.ExplicitLinOp(_jmat((2, 4), jdt, 23 + i))
                     for i in range(3)],
        "stencil": _jstencils(3),
        "stencil_equal": _jstencils(3, equal=True),
        "quadratic": [jfunc.SquaredL2Norm((3, 4)).asloss(_jmat((3, 4), jdt,
                                                               26 + i))
                      for i in range(3)],
        "l1_shift": [jfunc.L1Norm((3, 4)).asloss(_jmat((3, 4), jdt, 29 + i))
                     for i in range(3)],
    }[kind[1]]
    return (jop.stack if kind[0] == "stack" else jop.block_diag)(fam)


def _jproj(jdt):
    B = np.random.default_rng(2).standard_normal((5, 2))
    C = np.random.default_rng(3).standard_normal((5, 2))
    return _jby_matrix(jabc.ProjOp, jnp.asarray(
        B @ np.linalg.solve(C.T @ B, C.T)).astype(jdt))


def _jorth(jdt):
    Q = _jqr(4)
    return _jby_matrix(jabc.OrthProjOp, jnp.asarray(Q[:, :2] @ Q[:, :2].T)
                       .astype(jdt))


def _jjacobian(jdt):
    D = j_source(jabc.DiffMap, (3, 4), (3, 4),
                 apply=lambda v: jnp.tanh(v) * 2.0)
    return D.jacobian(_jmat((3, 4), jdt, 5))


JOPS = {
    "identity": lambda jdt: jlin.IdentityOp((3, 4)),
    "homothety": lambda jdt: jlin.HomothetyOp((3, 4), -1.5),
    "diagonal": lambda jdt: jlin.DiagonalOp(jnp.abs(_jmat((3, 4), jdt, 6))
                                            + 0.5),
    "explicit": lambda jdt: jlin.ExplicitLinOp(_jmat((3, 2, 4), jdt, 7)),
    "unit": lambda jdt: _jby_matrix(jabc.UnitOp,
                                    jnp.asarray(_jqr(1)).astype(jdt)),
    "proj": _jproj,
    "orth_proj": _jorth,
    "dagger": lambda jdt: jlin.ExplicitLinOp(_jmat((3, 4), jdt, 8))
    .dagger(0.1),
    "jacobian": _jjacobian,
    "argscale": lambda jdt: jlin.ExplicitLinOp(_jmat((4, 4), jdt, 9))
    .argscale(-0.5),
    "power": lambda jdt: jlin.ExplicitLinOp(_jmat((4, 4), jdt, 10) / 2) ** 3,
    "moreau_l1": lambda jdt: jfunc.L1Norm((3, 4)).moreau_envelope(0.4),
    "l2": lambda jdt: jfunc.L2Norm((3, 4)),
    "squared_l1": lambda jdt: jfunc.SquaredL1Norm((3, 4)),
    "squared_l1_root": lambda jdt: jfunc.SquaredL1Norm((3, 4), "root"),
    "linf": lambda jdt: jfunc.LInfinityNorm((3, 4)),
    "positive_l1": lambda jdt: jfunc.PositiveL1Norm((3, 4)),
    "constant": lambda jdt: JConst((3, 4), (), 1.5),
    "shift_loss": lambda jdt: jfunc.shift_loss(jfunc.SquaredL2Norm((3, 4)),
                                               _jmat((3, 4), jdt, 11)),
}
JOPS.update({f"{how}_{kind}": (lambda jdt, key=(how, kind):
                               _jblocks(key, jdt))
             for how, kind in (("block_diag", "diagonal"),
                               ("stack", "explicit"),
                               ("block_diag", "stencil"),
                               ("stack", "stencil"),
                               ("block_diag", "stencil_equal"),
                               ("block_diag", "quadratic"),
                               ("block_diag", "l1_shift"))})


def test_the_conformance_operators_have_jax_counterparts():
    assert set(JOPS) == set(OPS)


OP_CASES = [(op, name) for op in sorted(OPS) for name in DTYPES]


@pytest.mark.parametrize("opname,name", OP_CASES)
def test_conformance_operator_dtype_matches_jax(opname, name):
    tdt, jdt = DTYPES[name]
    top, jop_ = OPS[opname](tdt), JOPS[opname](jdt)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(top.dim_shape)
    tx, jx = _rounded(x, name)
    runs = [("apply", tx, jx)]
    if hasattr(top, "adjoint"):
        y = rng.standard_normal(top.codim_shape)
        runs.append(("adjoint",) + _rounded(y, name))
    for direction, t_in, j_in in runs:
        got = getattr(top, direction)(t_in)
        want = jax.eval_shape(getattr(jop_, direction), j_in)
        assert _T2J[got.dtype] == want.dtype, (direction, got.dtype,
                                               want.dtype)


# ------------------------------------------------ the narrow stencil kernel --

@pytest.mark.parametrize("name", ["bf16", "f16"])
@pytest.mark.parametrize("mode", ["constant", "symmetric"])
def test_narrow_plain_stencil_matches_jax(mode, name):
    """The plain 2-byte stencil (the kernel's arithmetic: taps rounded to
    the storage type, float32 sums, one rounding) against the JAX Stencil
    at that dtype, which rounds after each axis: within two ulps (of the
    storage type) of max|y|, apply and adjoint, one tap set and a member
    set; and bit for bit the float32 sums of the rounded taps, rounded
    once."""
    tdt, jdt = DTYPES[name]
    shape = (32, 48)
    k0, k1 = _gauss(9, 2.0), _gauss(5, 1.0)
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((2,) + shape).astype(np.float32)
    Kt = tlin.Stencil(shape, [k0, k1], [4, 2], mode=mode)
    Kj = jlin.Stencil(shape, [jnp.asarray(k0.astype(np.float32)),
                              jnp.asarray(k1.astype(np.float32))], [4, 2],
                      mode=mode)
    xb = torch.from_numpy(xs).to(tdt)
    xj = jnp.asarray(xs).astype(jdt)
    want = jax.jit(lambda a: (Kj.apply(a), Kj.adjoint(a)))(xj)
    got = (Kt.apply(xb), Kt.adjoint(xb))
    mt = st.MemberTaps([Kt._taps] * 2)
    got_m = tuple(st.separable_correlate2d_members(xb, mt, adj)
                  for adj in (False, True))
    for g, gm, wj in zip(got, got_m, want):
        assert g.dtype == gm.dtype == tdt
        w = np.asarray(wj.astype(jnp.float32))
        tol = 2 * _eps(tdt) * float(np.abs(w).max())
        for a in (g, gm):
            assert float(np.abs(a.float().numpy() - w).max()) <= tol
    q = st.SepTaps(st._narrow_taps(Kt._taps.k0, tdt), 4,
                   st._narrow_taps(Kt._taps.k1, tdt), 2, mode)
    assert torch.equal(got[0], st.separable_correlate2d_plain(
        xb.float(), q).to(tdt))


# ---------------------------------------------------------------- refusals --

@pytest.mark.parametrize("dt", [torch.int32, torch.complex64])
def test_other_dtypes_raise_naming_the_dtypes_taken(dt):
    x = torch.zeros((60, 2), dtype=dt)
    with pytest.raises(ValueError, match="bfloat16, float16, float32"):
        _ops("nufft_t1_d2")[0].apply(x)
    with pytest.raises(ValueError, match="float64, bfloat16 or float16"):
        st.separable_correlate2d(torch.zeros((8, 8), dtype=dt),
                                 _ops("stencil_kernel")[0]._taps)


def test_a_wrapper_takes_its_plans_dtype_only():
    A = _ops("nufft_t1_d2")[0]
    c = torch.zeros((1, A._M, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="this plan takes torch.float32"):
        nu.nufft_spread2(c, A._plan)


# -------------------------------------------------------- bf16 schedules --

_SCHED_T = [(torch.bfloat16, 10), (torch.float32, None)]
_SCHED_J = [(jnp.bfloat16, 10), (jnp.float32, None)]


def _port_fit(make, schedule=None):
    slv, fit, _ = make()
    slv.fit(stop_crit=MaxIter(20), max_iter=20, precision_schedule=schedule,
            **fit)
    return slv


def _jax_fit(make, schedule=None, n=20):
    slv, fit, _ = make()
    slv.fit(stop_crit=JMaxIter(n), max_iter=n, precision_schedule=schedule,
            **fit)
    return np.asarray(slv.solution()).astype(np.float64)


def _check_schedule(slv):
    assert [p["dtype"] for p in slv.phase_log] == ["bfloat16", "float32"]
    assert [p["iterations"] for p in slv.phase_log] == [10, 10]
    x = slv.solution()
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    return _np(x)


def test_bf16_schedule_ri_fit_matches_jax():
    """Radio interferometry: the port's scheduled solution within 1e-2 of
    max|x| of the JAX package's (measured 1.1e-3)."""
    got = _check_schedule(_port_fit(
        lambda: radio_interferometry((32, 32), n_vis=300, device="cpu"),
        _SCHED_T))
    want = _jax_fit(lambda: jri((32, 32), n_vis=300), _SCHED_J)
    assert float(np.abs(got - want).max()) <= 1e-2 * float(
        np.abs(want).max())


def test_bf16_schedule_fourier_ct_fit_matches_jax():
    """Sparse-view Fourier CT: the JAX package's bf16 phase raises in its
    real-input Toeplitz gram (``jnp.fft.rfftn`` refuses bfloat16) and its
    engine drops the phase, so its scheduled run is its 10-iteration
    float32 run (to float32 rounding).  The port runs the phase (the gram
    widens to float32): its scheduled solution lies within 1e-2 of max|x|
    of the JAX package's 20-iteration float32 solution (measured
    5.3e-3)."""
    def make():
        return jct((32, 32), 8, method="fourier")
    got = _check_schedule(_port_fit(
        lambda: sparse_view_ct((32, 32), 8, method="fourier", device="cpu"),
        _SCHED_T))
    dropped, f32_10 = _jax_fit(make, _SCHED_J), _jax_fit(make, None, n=10)
    assert float(np.abs(dropped - f32_10).max()) <= 1e-6 * float(
        np.abs(f32_10).max())
    want = _jax_fit(make)
    assert float(np.abs(got - want).max()) <= 1e-2 * float(
        np.abs(want).max())
