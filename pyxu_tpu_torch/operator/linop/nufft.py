r"""Non-uniform FFT, types 1 and 2 in d = 2 and d = 3 (counterpart of
``pyxu_tpu/operator/linop/nufft.py``).

The FINUFFT algorithm (Barnett, Magland, af Klinteberg) as the JAX package
writes it:

* the "exp-sqrt" (ES) spreading kernel phi(z) = exp(beta (sqrt(1 - z^2) - 1)),
  |z| <= 1, with width w and shape beta from the accuracy eps and the
  oversampling factor (2.0 or 1.25);
* an oversampled fine grid n_f = next_fast_len(ceil(sigma N)) per axis;
* type 1 = spread (scatter-add) -> FFT -> deconvolve by the kernel's
  Fourier factors phihat (Gauss-Legendre quadrature, host float64);
* type 2 = its adjoint with the opposite sign: deconvolve -> FFT ->
  interp (gather).

Spread and interp run through :mod:`pyxu_tpu_torch.ops.nufft`: the
hand-written CUDA kernels on a CUDA tensor, their plain versions on a CPU
tensor.  The decision is static (d = 2 or 3, a float32/float64 plan) and is
recorded on the operator as ``kernel_path``.  The FFTs are ``torch.fft``.

The JAX package's global x64 switch becomes the ``dtype`` given at plan
time: the plan's offsets and the inputs it takes are of that dtype.  The
public API is real-valued with a trailing size-2 axis
(:mod:`pyxu_tpu_torch.utils.complex`).

:class:`_NUFFTToeplitz` is the normal operator ``A^H A`` of a type-2
transform (and the type-1 ``A A^H``) by Toeplitz/circulant embedding: two
FFTs per apply and no spread or interp.  It is what ``A.gram()`` returns,
and what the rule engine builds a ``QuadraticFunc`` over for
``0.5 * SquaredL2Norm().asloss(y) * A``.

The Toeplitz gram takes the JAX package's ``scale``, ``weights`` and
``kernel_shift`` (the FourierRadon gram's weighted Toeplitz and shifted
Hankel sections).  Not ported yet (ROADMAP Queue 1): d = 1, type 3 and its
chunked plan, and the Toeplitz options ``_chan_lam`` and
``_circulant_precond``.
"""

from __future__ import annotations

import collections as _collections
import contextlib as _contextlib
import math as _math
import warnings as _warnings

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp, SelfAdjointOp
from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.info.warnings import PerformanceWarning
from pyxu_tpu_torch.ops import nufft as _kern
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.complex import view_as_complex, view_as_real
from pyxu_tpu_torch.utils.misc import next_fast_len

__all__ = ["NUFFT", "ES_kernel", "nudft1", "nudft2"]

_QUEUE = "is not ported yet: ROADMAP.md Queue 1, the rest of the NUFFT"

# Set-up tracing: None (off), or a callable(name) returning a context
# manager that times the named part of a plan, a Toeplitz build or a
# transform (chip_smoke.py's set-up breakdowns).
SPAN = None


def _span(name: str):
    return SPAN(name) if SPAN is not None else _contextlib.nullcontext()


# ----------------------------------------------------------- ES kernel -----

def _es_params(eps: float, upsampfac: float = 2.0):
    """Kernel width and shape from the accuracy eps (FINUFFT's defaults):
    w = ceil(log10(1/eps)) + 1 at sigma = 2, from the ES rate
    eps ~ exp(-pi w sqrt(1 - 1/sigma)) otherwise; beta = 0.976 pi w
    (1 - 1/(2 sigma))."""
    if abs(upsampfac - 2.0) < 1e-12:
        w = int(_math.ceil(_math.log10(1.0 / eps))) + 1
    else:
        rate = _math.pi * _math.sqrt(1.0 - 1.0 / upsampfac)
        w = int(_math.ceil(_math.log(1.0 / eps) / rate)) + 1
    w = max(2, min(16, w))
    beta = 0.976 * _math.pi * w * (1.0 - 1.0 / (2.0 * upsampfac))
    return w, beta


def ES_kernel(z, beta: float) -> np.ndarray:
    """Exponential-of-semicircle kernel phi_beta(z) = exp(beta(sqrt(1-z^2)-1))
    on |z| <= 1, 0 outside (host float64)."""
    if not beta > 0:
        raise ValueError(f"beta must be positive, got {beta}")
    z = np.asarray(z, np.float64)
    phi = np.zeros_like(z)
    mask = np.abs(z) <= 1
    phi[mask] = np.exp(beta * (np.sqrt(1.0 - z[mask] ** 2) - 1.0))
    return phi


NUFFT_PARAMS = _collections.namedtuple(
    "finufft_params",
    ["upsample_factor", "kernel_width", "kernel_beta", "fft_shape",
     "dilation_factor"])


def _phi_hat(n_modes: int, n_f: int, w: int, beta: float):
    """Fourier factors phihat(k), k = -N//2 .. (N-1)//2, of the h-scaled ES
    kernel by Gauss-Legendre quadrature of
    (w h / 2) int_{-1}^{1} phi(z) cos(k (w h / 2) z) dz / h, h = 2 pi / n_f
    (host float64)."""
    h = 2 * np.pi / n_f
    alpha = w * h / 2.0
    q = max(2 * w, 24)
    zq, wq = np.polynomial.legendre.leggauss(q)
    phi = np.exp(beta * (np.sqrt(np.clip(1 - zq ** 2, 0, None)) - 1.0))
    ks = np.arange(-(n_modes // 2), (n_modes + 1) // 2)
    c = np.cos(np.outer(ks * alpha, zq))
    return ks, alpha * (c * (phi * wq)).sum(axis=1) / h


def _points(x, device) -> torch.Tensor:
    """(M, d) float64 points on ``device``, folded into [0, 2 pi)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(device=device, dtype=torch.float64)
    else:
        x = torch.from_numpy(np.array(x, np.float64)).to(device)
    if x.ndim == 1:
        x = x[:, None]
    return torch.remainder(x, 2 * np.pi)


# ------------------------------------------------------------ type 1 / 2 ---

class _NUFFT12(LinOp):
    r"""Type-1 operator (nonuniform points -> uniform modes); type 2 is its
    adjoint.

    type 1, isign s:  f_k = sum_j c_j exp(s i <k, x_j>),  k in modes(N)
    type 2 (adjoint, isign -s): c_j = sum_k f_k exp(-s i <k, x_j>)

    Real view: dim (M, 2) (``(M,)`` with ``real_in``), codim (*N, 2).
    """

    def __init__(self, x, N, isign: int = +1, eps: float = 1e-6,
                 real_in: bool = False, upsampfac: float = 2.0, dtype=None,
                 device=None):
        dev = resolve_device(device, like=x)
        dtype = default_fdtype() if dtype is None else dtype
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: want float32 or float64")
        with _span("points"):
            xh = _points(x, dev)
        M, d = xh.shape
        N = (N,) * d if isinstance(N, (int, np.integer)) else tuple(
            int(n) for n in N)
        if len(N) != d:
            raise ValueError(f"N = {N} does not match the points' d = {d}")
        if d not in (2, 3):
            raise NotImplementedError(f"the d = {d} NUFFT {_QUEUE}")
        if upsampfac not in (1.25, 2.0):
            raise ValueError(f"upsampfac must be 1.25 or 2.0, got {upsampfac}")
        if upsampfac == 1.25:
            # low oversampling divides the edge modes by a tiny phihat: the
            # accuracy floors near 1e-5 in float32 (as in FINUFFT)
            eps_floor = 1e-9 if dtype == torch.float64 else 5e-5
            if eps < eps_floor:
                raise ValueError(
                    f"upsampfac={upsampfac} cannot reach eps={eps:g} at "
                    f"this precision (floor {eps_floor:g}); use "
                    "upsampfac=2.0 or float64")
        w, beta = _es_params(eps, upsampfac)
        self._M, self._d, self._N = M, d, N
        self._isign = int(np.sign(isign)) or 1
        self._w, self._beta, self._eps = w, beta, float(eps)
        self._upsampfac = float(upsampfac)
        self._real_in = bool(real_in)
        self._dtype = dtype
        self._nf = tuple(max(next_fast_len(int(np.ceil(upsampfac * n))),
                             2 * w + 1) for n in N)
        self._xh = xh
        with _span("phi_hat"):
            ph = np.ones((1,) * d)
            for ax in range(d):
                _, f = _phi_hat(N[ax], self._nf[ax], w, beta)
                shape = [1] * d
                shape[ax] = N[ax]
                ph = ph * f.reshape(shape)
            self._phihat = torch.from_numpy(1.0 / ph).to(device=dev,
                                                         dtype=dtype)
        plan = _kern.plan2 if d == 2 else _kern.plan3
        with _span("plan"):
            self._plan = plan(xh, self._nf, w, beta, dtype)
        self._spread = _kern.nufft_spread2 if d == 2 else _kern.nufft_spread3
        self._interp = _kern.nufft_interp2 if d == 2 else _kern.nufft_interp3
        self.kernel_path = "kernel"
        super().__init__((M,) if real_in else (M, 2), N + (2,))
        self._lipschitz = float(np.sqrt(np.prod(N) * M))
        self._name = f"NUFFT1[d={d}]"

    def params(self) -> NUFFT_PARAMS:
        """The plan's parameters."""
        return NUFFT_PARAMS(upsample_factor=self._upsampfac,
                            kernel_width=self._w, kernel_beta=self._beta,
                            fft_shape=tuple(self._nf), dilation_factor=None)

    # -- helpers (batched: a leading axis B) ---------------------------------
    def _extract(self, ghat):
        """Centered modes out of the fine DFT array: mode k sits at index
        k mod n_f, so per axis the negative then the non-negative slab."""
        out = ghat
        for ax, (n, nf) in enumerate(zip(self._N, self._nf)):
            dim = ax + 1
            out = torch.cat([out.narrow(dim, nf - n // 2, n // 2),
                             out.narrow(dim, 0, (n + 1) // 2)], dim=dim)
        return out

    def _embed(self, f):
        """Centered modes into a zero fine DFT array (transpose of
        :meth:`_extract`)."""
        out = f
        for ax, (n, nf) in enumerate(zip(self._N, self._nf)):
            dim = ax + 1
            shape = list(out.shape)
            shape[dim] = nf - n
            zero = out.new_zeros(shape)
            out = torch.cat([out.narrow(dim, n // 2, n - n // 2), zero,
                             out.narrow(dim, 0, n // 2)], dim=dim)
        return out

    def _grid_to_modes(self, g):
        """Fine grid (B, *nf) complex -> deconvolved centered modes: f_k =
        sum_m g_m e^{s i k m h}, the unnormalised inverse DFT for s > 0."""
        dims = tuple(range(1, self._d + 1))
        if self._isign > 0:
            ghat = torch.fft.ifftn(g, dim=dims, norm="forward")
        else:
            ghat = torch.fft.fftn(g, dim=dims)
        return self._extract(ghat) * self._phihat

    def _modes_to_grid(self, f):
        """Centered modes (B, *N) complex -> the fine grid ready for interp
        (transpose of :meth:`_grid_to_modes`)."""
        dims = tuple(range(1, self._d + 1))
        g = self._embed(f * self._phihat)
        if self._isign > 0:
            return torch.fft.fftn(g, dim=dims)
        return torch.fft.ifftn(g, dim=dims, norm="forward")

    def _t1(self, c):
        """Strengths (B, M, 2) -> modes (B, *N) complex."""
        with _span("spread"):
            g = self._spread(c.contiguous(), self._plan)
        with _span("fft"):
            return self._grid_to_modes(view_as_complex(g))

    def _t2(self, f):
        """Modes (B, *N) complex -> values (B, M, 2), isign -s."""
        with _span("fft"):
            g = view_as_real(self._modes_to_grid(f)).contiguous()
        with _span("interp"):
            return self._interp(g, self._plan)

    # -- LinOp interface (real views) ----------------------------------------
    def apply(self, arr):
        if self._real_in:
            def single(a):
                return view_as_real(self._t1(
                    torch.stack([a, torch.zeros_like(a)], dim=-1)))
            return self._map_batched(single, arr, 1, self.codim_shape)

        def single(a):
            return view_as_real(self._t1(a))
        return self._map_batched(single, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        def single(a):
            c = self._t2(view_as_complex(a))
            return c[..., 0] if self._real_in else c
        return self._map_batched(single, arr, self._d + 1, self.dim_shape)

    def cogram(self) -> "SelfAdjointOp":
        """A A^H on the mode grid by Toeplitz/circulant embedding (two FFTs
        per apply).  ``real_in`` plans take the generic composition: their
        real-restricted adjoint puts a Re() between the factors, which the
        circulant kernel does not represent."""
        if self._real_in:
            return super().cogram()
        with _span("toeplitz build"):
            return _NUFFTToeplitz(self._xh, self._N, self._isign, self._eps,
                                  dtype=self._dtype)


class _NUFFT2(LinOp):
    """Type 2: the adjoint of a :class:`_NUFFT12` planned with the opposite
    isign."""

    def __init__(self, x, N, isign: int = -1, eps: float = 1e-6,
                 upsampfac: float = 2.0, real_in: bool = False, dtype=None,
                 device=None):
        with _span("type-1 plan"):
            self._t1op = _NUFFT12(x, N, isign=-isign, eps=eps,
                                  upsampfac=upsampfac, dtype=dtype,
                                  device=device)
        self._isign = int(np.sign(isign)) or -1
        self._real_in = bool(real_in)
        N_ = self._t1op._N
        super().__init__(N_ if real_in else N_ + (2,), (self._t1op._M, 2))
        self._lipschitz = self._t1op._lipschitz
        self.kernel_path = self._t1op.kernel_path
        self._name = f"NUFFT2[d={self._t1op._d}]"

    def params(self) -> NUFFT_PARAMS:
        return self._t1op.params()

    def apply(self, arr):
        if self._real_in:
            arr = torch.stack([arr, torch.zeros_like(arr)], dim=-1)
        return self._t1op.adjoint(arr)

    def adjoint(self, arr):
        out = self._t1op.apply(arr)
        return out[..., 0] if self._real_in else out

    def gram(self) -> "SelfAdjointOp":
        """A^H A on the mode grid by Toeplitz/circulant embedding (two FFTs
        per apply, no spread or interp; see :class:`_NUFFTToeplitz`)."""
        t1 = self._t1op
        with _span("toeplitz build"):
            return _NUFFTToeplitz(t1._xh, t1._N, t1._isign, t1._eps,
                                  real_in=self._real_in, dtype=t1._dtype)


class _NUFFTToeplitz(SelfAdjointOp):
    r"""NUFFT normal operator by Toeplitz/circulant embedding.

    For the type-2 operator :math:`A[m,k] = e^{i s \langle k, x_m\rangle}`,

    .. math:: (A^H A f)[k] = \sum_{k'} T[k-k'] f[k'],\qquad
              T[j] = \sum_m w_m e^{-i s \langle j, x_m\rangle},

    a uniform convolution over the mode grid, with the weights ``w``
    (default ones) and times ``scale``.  One apply zero-pads to the
    ``next_fast_len(2N-1)`` circulant grid, multiplies the FFT by the
    kernel's spectrum and crops the inverse FFT.  ``T`` is built once, at
    construction, by one type-1 NUFFT of the weights (one spread), at the
    parent's eps for a float32 plan and at ``min(eps, 1e-9)`` for a float64
    one; in 3-D at upsampfac 1.25 where that eps allows it (``>= 5e-5``),
    which makes the build's fine grid 2.5N per axis instead of 4N, else at
    2.

    ``kernel_shift``: a per-axis offset ``d`` so that the apply computes
    ``sum_{k'} T[k - k' + d] f[k']``; with an input flipped by the caller
    this evaluates a Hankel section ``sum_{k'} T[k + k'] f[k']`` (the
    FourierRadon gram's Nyquist term).  The build's mode grid is widened
    to ``2(N + |d|) - 1`` per axis to hold lags ``[-(N-1)+d, (N-1)+d]``.  A
    shifted kernel is not Hermitian: the operator acts with ``Re(T)``,
    whose circulant spectrum is complex, so it takes ``real_in`` only.

    ``real_in``: the operator acts on real images with ``Re(T)``; unshifted,
    its spectrum is the even-symmetrised real spectrum, and the apply runs
    on the rfft half spectrum.
    """

    def __init__(self, xh: torch.Tensor, N, isign: int, eps: float,
                 real_in: bool = False, dtype=None, scale: float = 1.0,
                 weights=None, kernel_shift=None):
        N = tuple(N)
        d = len(N)
        M = xh.shape[0]
        dtype = default_fdtype() if dtype is None else dtype
        shift = tuple(int(v) for v in (kernel_shift or (0,) * d))
        if len(shift) != d:
            raise ValueError(f"kernel_shift {shift}: want {d} offsets")
        self._spec_complex = any(shift)
        if self._spec_complex and not real_in:
            raise ValueError("a shifted (Hankel) kernel takes real_in only")
        self._N, self._d, self._M = N, d, M
        self._isign = int(np.sign(isign)) or 1
        self._eps = float(eps)
        self._real_in = bool(real_in)
        self._scale = float(scale)
        self._P = tuple(next_fast_len(2 * n - 1) for n in N)
        super().__init__(N if real_in else N + (2,))
        Nbig = tuple(2 * (n + abs(sh)) - 1 for n, sh in zip(N, shift))
        eps_T = min(eps, 1e-9) if dtype == torch.float64 else eps
        upsampfac = 1.25 if (d == 3 and eps_T >= 5e-5) else 2.0
        with _span("type-1 plan"):
            t1 = _NUFFT12(xh, Nbig, isign=self._isign, eps=eps_T,
                          upsampfac=upsampfac, dtype=dtype, device=xh.device)
        self._build_params = t1.params()
        c = torch.zeros((M, 2), dtype=dtype, device=xh.device)
        if weights is None:
            c[:, 0] = 1.0
            self._wsum = float(M)
        else:
            w = torch.as_tensor(weights, dtype=torch.float64)
            c[:, 0] = w.to(device=xh.device, dtype=dtype)
            self._wsum = float(w.sum())
        T = view_as_complex(t1.apply(c))               # (*Nbig) complex
        with _span("pad, roll, fftn"):
            # index i of the build grid holds lag i - Nbig//2: keep the lags
            # [-(n-1)+sh, (n-1)+sh] of each axis
            for ax, (n, nb, sh) in enumerate(zip(N, Nbig, shift)):
                T = T.narrow(ax, -(n - 1) + sh + nb // 2, 2 * n - 1)
            T = torch.nn.functional.pad(
                T, [v for p, n in zip(reversed(self._P), reversed(N))
                    for v in (0, p - (2 * n - 1))])
            # sliced index m holds lag -(n-1)+sh+m: rotate so that lag j
            # sits at (j - sh) mod P
            T = torch.roll(T, shifts=tuple(-(n - 1) for n in N),
                           dims=tuple(range(d)))
            half = self._P[-1] // 2 + 1
            self._that_half = None
            if self._spec_complex:
                # the spectrum of Re(T), complex
                self._that = self._scale * torch.fft.fftn(T.real)
                self._that_half = self._that[..., :half].contiguous()
            else:
                self._that = self._scale * torch.fft.fftn(T).real \
                    .contiguous()
                if real_in:
                    neg = self._that
                    for ax in range(d):
                        neg = torch.roll(torch.flip(neg, (ax,)), 1, ax)
                    lam_sym = 0.5 * (self._that + neg)
                    self._that_half = lam_sym[..., :half].contiguous()
        # the largest circulant eigenvalue bounds the section's norm
        with _span("lipschitz read"):
            self._lipschitz = float(self._that.abs().max()
                                    if self._spec_complex
                                    else self._that.max())
        self._name = f"NUFFTGram[d={d}]"

    def _conv(self, F):
        """Circulant-embedded linear convolution of complex modes
        (B, *N)."""
        dims = tuple(range(1, self._d + 1))
        g = torch.fft.fftn(F, s=self._P, dim=dims) * self._that
        out = torch.fft.ifftn(g, dim=dims)
        for ax, n in enumerate(self._N):
            out = out.narrow(ax + 1, 0, n)
        return out

    def _conv_real(self, x):
        """The same for real inputs (B, *N) on the half spectrum: the data's
        and the kernel's spectra are Hermitian (the kernel, shifted or not,
        is real), so ``irfftn`` of the product is exactly the real part of
        the full convolution."""
        dims = tuple(range(1, self._d + 1))
        g = torch.fft.rfftn(x, s=self._P, dim=dims) * self._that_half
        out = torch.fft.irfftn(g, s=self._P, dim=dims)
        for ax, n in enumerate(self._N):
            out = out.narrow(ax + 1, 0, n)
        return out

    def apply(self, arr):
        if self._real_in:
            return self._map_batched(self._conv_real, arr, self._d,
                                     self.codim_shape)

        def single(a):
            return view_as_real(self._conv(view_as_complex(a)))
        return self._map_batched(single, arr, self._d + 1, self.codim_shape)

    def adjoint(self, arr):
        return self.apply(arr)

    def trace(self, **kwargs) -> float:
        """Exact for an unshifted kernel: every diagonal entry is
        ``scale T[0] = scale sum(w)`` (twice per complex entry in the real
        view).  A shifted kernel's diagonal varies (``T[2k + d]``): the
        generic estimator (``kwargs``), by default exact, on the kernel's
        device and dtype."""
        if self._spec_complex:
            kwargs.setdefault("device", self._that.device)
            kwargs.setdefault("dtype", self._that.real.dtype)
            return super().trace(**kwargs)
        mult = 1 if self._real_in else 2
        return self._scale * self._wsum * float(np.prod(self._N)) * mult


# ----------------------------------------------------------- public API ----

class NUFFT:
    """Factory namespace: ``NUFFT.type1`` and ``NUFFT.type2`` for d = 2
    and d = 3.

    ``dtype`` (default: the precision policy's) and ``device`` (default:
    the points' if they are a tensor, else ``cuda``) are fixed at plan
    time; the JAX package takes the precision from its global x64 switch.
    """

    @staticmethod
    def type1(x, N, isign: int = +1, eps: float = 1e-6, real: bool = False,
              upsampfac: float = 2.0, dtype=None, device=None,
              **plan_kwargs):
        _ignore_finufft_kwargs(plan_kwargs)
        return _NUFFT12(x, N, isign=isign, eps=eps, real_in=real,
                        upsampfac=upsampfac, dtype=dtype, device=device)

    @staticmethod
    def type2(x, N, isign: int = -1, eps: float = 1e-6, real: bool = False,
              upsampfac: float = 2.0, dtype=None, device=None,
              **plan_kwargs):
        _ignore_finufft_kwargs(plan_kwargs)
        return _NUFFT2(x, N, isign=isign, eps=eps, upsampfac=upsampfac,
                       real_in=real, dtype=dtype, device=device)

    @staticmethod
    def type3(x, z, isign: int = +1, eps: float = 1e-6, real: bool = False,
              **plan_kwargs):
        raise NotImplementedError(f"the type-3 NUFFT {_QUEUE}")


# performance-only FINUFFT options: results are identical without them
_FINUFFT_ONLY_KWARGS = {
    "n_trans", "nthreads", "debug", "spread_debug", "showwarn", "fftw",
    "spread_sort", "spread_kerevalmeth", "spread_kerpad", "chkbnds",
    "gpu_method", "gpu_sort", "plan_fp", "enable_warnings", "parallel",
    "plan_fw", "plan_bw",
}
# options that change the result: refused
_FINUFFT_SEMANTIC_KWARGS = {
    "modeord": "FFT-ordered output modes are not supported; outputs are "
               "centered (modeord=0).  torch.fft.ifftshift the result "
               "instead.",
}


def _ignore_finufft_kwargs(kwargs: dict) -> None:
    """Tolerate FINUFFT's performance options (warned about once per call
    site); refuse ``modeord`` != 0 with NotImplementedError and unknown
    names with TypeError."""
    for name, msg in _FINUFFT_SEMANTIC_KWARGS.items():
        if kwargs.get(name):
            raise NotImplementedError(f"{name}={kwargs[name]!r}: {msg}")
        kwargs.pop(name, None)
    unknown = set(kwargs) - _FINUFFT_ONLY_KWARGS
    if unknown:
        raise TypeError(f"unknown NUFFT plan option(s): {sorted(unknown)}")
    if kwargs:
        _warnings.warn(
            f"NUFFT plan options ignored on this backend: {sorted(kwargs)} "
            "(batching is automatic via leading batch axes; threading and "
            "debug options are FINUFFT's)", PerformanceWarning, stacklevel=3)


# ------------------------------------------------- direct (test) evaluators -

def _modes(N):
    grids = np.meshgrid(*[np.arange(-(n // 2), (n + 1) // 2) for n in N],
                        indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)     # (prod N, d)


def nudft1(c, x, N, isign=+1):
    """Direct type 1, O(MN): f_k = sum_j c_j e^{isign i <k, x_j>} (host
    numpy)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    N = (N,) * x.shape[1] if isinstance(N, int) else tuple(N)
    return (np.exp(1j * isign * (_modes(N) @ x.T)) @ np.asarray(c)) \
        .reshape(N)


def nudft2(f, x, N, isign=-1):
    """Direct type 2: c_j = sum_k f_k e^{isign i <k, x_j>} (host numpy)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    N = (N,) * x.shape[1] if isinstance(N, int) else tuple(N)
    return np.exp(1j * isign * (x @ _modes(N).T)) @ np.asarray(f).ravel()
