r"""Fused Condat-Vu TV-deconvolution iteration (counterpart of
``pyxu_tpu/ops/fused_tv.py``).

Pattern handled (the TV-deconvolution family)::

    min_x 0.5*cst*||K x||^2 + <b, x> (+ const) + lam*||D x||_{2,1}

with ``K`` a 2-D separable correlation (boundary ``symmetric`` or
``constant``), ``D`` the first-order forward-difference gradient with the
same boundary modes, and the dual prox the per-pixel L21 block soft
threshold.

Each kernel has its plain PyTorch version beside it:

* :func:`tv_step_ref` — full-frame expression of one iteration (the
  counterpart of ``tv_step_xla``), in the inputs' dtype;
* :func:`tv_step_plain` / :func:`tv_stepk_plain` — one / K iterations with
  the kernels' storage contract: x and z stored in f32 or bf16 each (f64
  too, on the CPU), arithmetic in f32 (or f64), state rounded through the
  storage dtype after every iteration;
* :func:`tv_step` / :func:`tv_stepk` — the wrappers.  On a CUDA tensor they
  launch the hand-written kernels of ``csrc/fused_tv.cu`` (or raise); on a
  CPU tensor they run the plain version.  ``tv_step.launches`` and
  ``tv_stepk.launches`` count kernel launches.

The kernels are built with ``nvcc`` at first use into ``csrc/_build/`` and
loaded with ``ctypes``.  ``match_fused_tv`` / ``match_fused_tv2`` decide
once, at solver init, whether a problem takes this path and with how many
iterations per K-step pass.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pyxu_tpu_torch.ops._build import compile_and_load
from pyxu_tpu_torch.ops.stencil import adj_axis, fwd_axis

__all__ = [
    "TVParams",
    "tv_step_ref",
    "tv_step_plain",
    "tv_stepk_plain",
    "tv_step",
    "tv_stepk",
    "build",
    "match_fused_tv",
    "match_fused_tv2",
]

_F32_TINY = float(np.finfo(np.float32).tiny)


# ------------------------------------------------------------ plain version --

def _fdiff(v, ax, mode):
    """Forward difference with boundary pad (Gradient semantics)."""
    n = v.shape[ax]
    d = v.narrow(ax, 1, n - 1) - v.narrow(ax, 0, n - 1)
    last = v.narrow(ax, n - 1, 1)
    last = torch.zeros_like(last) if mode == "symmetric" else -last
    return torch.cat([d, last], dim=ax)


def _fdiff_adjoint(g, ax, mode):
    """Adjoint of _fdiff: d[0] = -g[0]; d[i] = g[i-1] - g[i]; symmetric
    adds g[n-1] back onto d[n-1]."""
    n = g.shape[ax]
    out = torch.cat([-g.narrow(ax, 0, 1),
                     g.narrow(ax, 0, n - 1) - g.narrow(ax, 1, n - 1)], dim=ax)
    if mode == "symmetric":
        out = torch.cat([out.narrow(ax, 0, n - 1),
                         out.narrow(ax, n - 1, 1) + g.narrow(ax, n - 1, 1)],
                        dim=ax)
    return out


def _l21_fenchel(zt0, zt1, lam):
    """z - sigma prox_{lam/sigma L21}(z/sigma) in the direct form
    zt * min(lam rsqrt(||zt||^2), 1)."""
    n2 = zt0 * zt0 + zt1 * zt1
    fac = torch.clamp(lam * torch.rsqrt(torch.clamp(n2, min=_F32_TINY)),
                      max=1.0)
    return zt0 * fac, zt1 * fac


def tv_step_ref(x, z0, z1, b, k0, k1, c0, c1, *, cst, lam, tau, sigma, rho,
                mode_k="symmetric", mode_d="symmetric"):
    """One Condat-Vu iteration of the TV family, full-frame, in the inputs'
    dtype; the counterpart of ``tv_step_xla``."""
    Kx = fwd_axis(fwd_axis(x, k0, c0, 0, mode_k), k1, c1, 1, mode_k)
    KtKx = adj_axis(adj_axis(Kx, k1, c1, 1, mode_k), k0, c0, 0, mode_k)
    gf = cst * KtKx + b
    dtz = _fdiff_adjoint(z0, 0, mode_d) + _fdiff_adjoint(z1, 1, mode_d)
    xp = x - tau * (gf + dtz)
    v = 2.0 * xp - x
    zt0 = z0 + sigma * _fdiff(v, 0, mode_d)
    zt1 = z1 + sigma * _fdiff(v, 1, mode_d)
    zp0, zp1 = _l21_fenchel(zt0, zt1, lam)
    if rho == 1.0:
        return xp, zp0, zp1
    return (x + rho * (xp - x), z0 + rho * (zp0 - z0), z1 + rho * (zp1 - z1))


@dataclasses.dataclass(frozen=True)
class TVParams:
    """Static data of one fused TV problem: taps (host floats), centres,
    step sizes and boundary modes."""

    k0: tuple
    k1: tuple
    c0: int
    c1: int
    cst: float
    lam: float
    tau: float
    sigma: float
    rho: float
    mode_k: str = "symmetric"
    mode_d: str = "symmetric"

    @property
    def halo(self) -> tuple:
        """Per-stage halo max(lo, hi) of K along rows and columns."""
        return (max(self.c0, len(self.k0) - 1 - self.c0),
                max(self.c1, len(self.k1) - 1 - self.c1))

    @property
    def apron(self) -> tuple:
        """Pixels one iteration's dependency cone adds per side, along rows
        and columns: ``K^T K`` reaches 2*halo, ``D`` and ``D^T`` one."""
        return tuple(max(2 * h, 1) for h in self.halo)


def _compute_dtype(x, z):
    if torch.bfloat16 in (x.dtype, z.dtype):
        return torch.float32
    return torch.promote_types(x.dtype, z.dtype)


def tv_step_plain(x, z, b, p: TVParams):
    """One iteration under the kernels' storage contract: ``x`` (H, W) and
    ``z`` (2, H, W) in their own storage dtypes, arithmetic in the compute
    dtype, results rounded to the storage dtypes."""
    cdt = _compute_dtype(x, z)
    xn, z0n, z1n = tv_step_ref(
        x.to(cdt), z[0].to(cdt), z[1].to(cdt), b.to(cdt), p.k0, p.k1,
        p.c0, p.c1, cst=p.cst, lam=p.lam, tau=p.tau, sigma=p.sigma,
        rho=p.rho, mode_k=p.mode_k, mode_d=p.mode_d)
    return xn.to(x.dtype), torch.stack([z0n, z1n]).to(z.dtype)


def tv_stepk_plain(x, z, b, p: TVParams, n_steps: int):
    """``n_steps`` chained :func:`tv_step_plain` iterations (the state
    round-trips through its storage dtype between them)."""
    for _ in range(int(n_steps)):
        x, z = tv_step_plain(x, z, b, p)
    return x, z


# ------------------------------------------------------------ CUDA kernels --

_TILES = {1: (32, 32), "k": (48, 64)}   # output tile (rows, cols) of a
                                        # block: TV_TR/TV_TC, TV_TR_K/TV_TC_K
_MAX_TAPS = 32         # TV_MAXL
_MAX_SMEM = 232448     # dynamic shared memory a block may opt in to (H100)


def _window(p: TVParams, n_steps: int) -> tuple:
    """(rows, cols) of one block's window in ``csrc/fused_tv.cu``: its
    output tile, an apron of ``n_steps * apron`` per side, one more row and
    column for the forward difference."""
    tr, tc = _TILES[1 if n_steps == 1 else "k"]
    g0, g1 = p.apron
    return tr + 2 * n_steps * g0 + 1, tc + 2 * n_steps * g1 + 1


def smem_bytes(p: TVParams, n_steps: int) -> int:
    """Dynamic shared memory of one block: five f32 arrays of the window."""
    nr, nc = _window(p, n_steps)
    return 5 * nr * nc * 4


def window_fits(shape, p: TVParams, n_steps: int) -> bool:
    """Whether one block's window at ``n_steps`` levels lies inside the
    image and its shared memory inside the card's limit.  A window wider
    than the image recomputes more than a pass saves."""
    nr, nc = _window(p, n_steps)
    return (nr <= shape[0] and nc <= shape[1]
            and smem_bytes(p, n_steps) <= _MAX_SMEM)


@functools.cache
def _library():
    """Compile ``csrc/fused_tv.cu`` (once per source hash) and load it."""
    lib, log = compile_and_load("fused_tv.cu")
    common = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 5
    lib.tv_step_launch.argtypes = common + [ctypes.c_void_p]
    lib.tv_step_launch.restype = ctypes.c_int
    lib.tv_stepk_launch.argtypes = common + [ctypes.c_int, ctypes.c_void_p]
    lib.tv_stepk_launch.restype = ctypes.c_int
    lib.tv_error_string.argtypes = [ctypes.c_int]
    lib.tv_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build and load the kernels; returns the compiler's output (empty when
    the library was already built)."""
    return _library()[1]


def _check(x, z, b, p: TVParams, n_steps: int):
    ok_dt = (torch.float32, torch.bfloat16)
    if not (x.is_cuda and z.device == x.device and b.device == x.device):
        raise ValueError("x, z and b must lie on one CUDA device")
    if x.dtype not in ok_dt or z.dtype not in ok_dt:
        raise ValueError(f"storage dtypes {x.dtype}/{z.dtype}: the kernel "
                         "takes float32 or bfloat16")
    if b.dtype != torch.float32:
        raise ValueError(f"b must be float32, got {b.dtype}")
    if x.ndim != 2 or z.shape != (2,) + tuple(x.shape) or b.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
                         f"b {tuple(b.shape)}: want (H, W), (2, H, W), (H, W)")
    if not (x.is_contiguous() and z.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, z and b must be contiguous")
    if max(len(p.k0), len(p.k1)) > _MAX_TAPS:
        raise ValueError(f"at most {_MAX_TAPS} taps per axis")
    if min(x.shape) < max(p.halo) + 1:
        raise ValueError("image smaller than the blur's pad width")
    if smem_bytes(p, n_steps) > _MAX_SMEM:
        raise ValueError(f"{n_steps} levels need {smem_bytes(p, n_steps)} B "
                         "of shared memory per block")


def _launch(entry, x, z, b, p: TVParams, *extra):
    lib, _ = _library()
    xo, zo = torch.empty_like(x), torch.empty_like(z)
    k0 = (ctypes.c_float * len(p.k0))(*p.k0)
    k1 = (ctypes.c_float * len(p.k1))(*p.k1)
    H, W = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), z.data_ptr(), b.data_ptr(), xo.data_ptr(),
            zo.data_ptr(), H, W, int(x.dtype == torch.bfloat16),
            int(z.dtype == torch.bfloat16), k0, len(p.k0), p.c0, k1,
            len(p.k1), p.c1, int(p.mode_k == "symmetric"),
            int(p.mode_d == "symmetric"), p.cst, p.lam, p.tau, p.sigma,
            p.rho, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({lib.tv_error_string(err).decode()})")
    return xo, zo


def tv_step(x, z, b, p: TVParams):
    """One fused iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return tv_step_plain(x, z, b, p)
    _check(x, z, b, p, 1)
    tv_step.launches += 1
    return _launch("tv_step_launch", x, z, b, p)


tv_step.launches = 0


def tv_stepk(x, z, b, p: TVParams, n_steps: int):
    """``n_steps`` (>= 2) fused iterations in one pass: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    n_steps = int(n_steps)
    if n_steps < 2:
        raise ValueError("tv_stepk takes n_steps >= 2; use tv_step")
    if x.device.type == "cpu":
        return tv_stepk_plain(x, z, b, p, n_steps)
    _check(x, z, b, p, n_steps)
    tv_stepk.launches += 1
    return _launch("tv_stepk_launch", x, z, b, p, n_steps)


tv_stepk.launches = 0


# ------------------------------------------------------------ pattern match --

def _unwrap_scale_cast(op):
    """Strip Cast/Scale wrappers, returning (base_op, accumulated_scale)."""
    from pyxu_tpu_torch.abc.arithmetic import CastMixin, ScaleMixin
    cst = 1.0
    while True:
        if isinstance(op, ScaleMixin):
            cst *= op._cst
            op = op._op
        elif isinstance(op, CastMixin):
            op = op._op
        else:
            return op, cst


def _stencil_taps_2d(st):
    """(k0, c0, k1, c1, mode) of a 2-D separable Stencil, or None."""
    from pyxu_tpu_torch.operator.linop.stencil import Stencil
    if not isinstance(st, Stencil) or st.dim_rank != 2:
        return None
    if st._mode not in ("symmetric", "constant") or len(st._kernels) != 2:
        return None
    k0, k1 = st._kernels
    if not (k0.shape[1] == 1 and k1.shape[0] == 1):
        return None
    return (tuple(float(v) for v in k0.ravel()), int(st._centers[0][0]),
            tuple(float(v) for v in k1.ravel()), int(st._centers[1][1]),
            st._mode)


def _gradient_mode_2d(K):
    """Boundary mode of a 2-D first-order forward-difference Gradient, or
    None when K is not of that exact form."""
    from pyxu_tpu_torch.operator.linop.diff import _StackedDiff
    from pyxu_tpu_torch.operator.linop.stencil import Stencil
    if not isinstance(K, _StackedDiff) or len(K._ops) != 2:
        return None
    modes = []
    for ax, op in enumerate(K._ops):
        if not isinstance(op, Stencil) or op.dim_rank != 2:
            return None
        want = [1, 1]
        want[ax] = 2
        found = False
        for k, ctr in zip(op._kernels, op._centers):
            if ctr != (0, 0):
                return None
            if k.shape == (1, 1):
                if not np.allclose(k.ravel(), [1.0]):
                    return None
                continue
            if found or k.shape != tuple(want) or \
                    not np.allclose(k.ravel(), [-1.0, 1.0]):
                return None
            found = True
        if not found or op._mode not in ("symmetric", "constant"):
            return None
        modes.append(op._mode)
    return modes[0] if modes[0] == modes[1] else None


@dataclasses.dataclass
class FusedTV:
    """A matched TV problem: its static data and the linear term ``b``."""

    params: TVParams
    b: torch.Tensor

    def step(self, x, z):
        return tv_step(x, z, self.b, self.params)

    def stepk(self, x, z, n_steps: int):
        return tv_stepk(x, z, self.b, self.params, n_steps)


def match_fused_tv(f, g, h, K, *, tau, sigma, rho, x, z):
    """A :class:`FusedTV` when ``(f, g, h, K)`` is the TV family and the
    state ``(x, z)`` suits the fused step on its device, else None.

    On a CUDA device the state must be stored in float32 or bfloat16 (what
    the kernel takes); on the CPU the plain version takes any float dtype.
    The image must hold one single-step window (see :func:`window_fits`)."""
    from pyxu_tpu_torch.abc.operator import QuadraticFunc, _GramOp
    from pyxu_tpu_torch.operator.func.norm import L21Norm
    from pyxu_tpu_torch.operator.linop.base import NullFunc

    if not (g is None or isinstance(g, NullFunc)) or h is None or K is None:
        return None
    if type(f) is not QuadraticFunc or x.ndim != 2 or z is None:
        return None
    if x.is_cuda and not {x.dtype, z.dtype} <= {torch.float32, torch.bfloat16}:
        return None
    Q, c, _ = f._quad_spec()
    Qb, cst = _unwrap_scale_cast(Q)
    if not isinstance(Qb, _GramOp):
        return None
    taps = _stencil_taps_2d(Qb._op)
    if taps is None or cst <= 0:
        return None
    k0, c0, k1, c1, mode_k = taps
    hb, lam = _unwrap_scale_cast(h)
    if not (isinstance(hb, L21Norm) and lam > 0):
        return None
    if hb._l2_axis != (0,) or hb.dim_rank != 3 or hb.dim_shape[0] != 2:
        return None
    mode_d = _gradient_mode_2d(K)
    if mode_d is None or f.dim_shape != tuple(x.shape) \
            or hb.dim_shape[1:] != f.dim_shape:
        return None
    p = TVParams(k0=k0, k1=k1, c0=c0, c1=c1, cst=float(cst), lam=float(lam),
                 tau=float(tau), sigma=float(sigma), rho=float(rho),
                 mode_k=mode_k, mode_d=mode_d)
    if not window_fits(f.dim_shape, p, 1):
        return None
    bdt = torch.float32 if x.is_cuda else _compute_dtype(x, z)
    b = c.grad(torch.zeros(f.dim_shape, dtype=bdt, device=x.device))
    return FusedTV(p, b.contiguous())


def match_fused_tv2(fused: FusedTV, shape, n_steps: int = 3):
    """Iterations per K-step pass for a matched problem, or None.

    Starts at ``n_steps`` (3 by default) and steps down while a block's
    window exceeds the image or the shared memory (the step-down rule of
    the JAX package's ``match_fused_tv2``); None below 2."""
    while n_steps >= 2 and not window_fits(shape, fused.params, n_steps):
        n_steps -= 1
    return n_steps if n_steps >= 2 else None
