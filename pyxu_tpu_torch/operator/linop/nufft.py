r"""Non-uniform FFT, types 1, 2 and 3 in d = 1, 2 and 3 (counterpart of
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
  interp (gather);
* type 3 = spread at the rescaled points -> FFT -> interp at the rescaled
  frequencies, with a deconvolution on each side and centring phases
  (:class:`_NUFFT3`), or the same on blocks of a partition of both clouds
  (:class:`_NUFFT3Chunked`).

Spread and interp run through :mod:`pyxu_tpu_torch.ops.nufft`: at d = 2
and 3 the hand-written CUDA kernels on a CUDA tensor and their plain
versions on a CPU tensor; at d = 1, which has no kernel (nor a Pallas one
in the JAX package), the plain versions on either device.  The decision is
static (d and a float32/float64 plan) and is recorded on the operator as
``kernel_path`` (``"kernel"`` or ``"plain"``).  The FFTs are ``torch.fft``.

The JAX package's global x64 switch becomes the ``dtype`` given at plan
time: the plan's offsets and the inputs it takes are of that dtype.  The
public API is real-valued with a trailing size-2 axis
(:mod:`pyxu_tpu_torch.utils.complex`).

:class:`_NUFFTToeplitz` is the normal operator ``A^H A`` of a type-2
transform (and the type-1 ``A A^H``) by Toeplitz/circulant embedding: two
FFTs per apply and no spread or interp.  It is what ``A.gram()`` returns,
and what the rule engine builds a ``QuadraticFunc`` over for
``0.5 * SquaredL2Norm().asloss(y) * A``.  It takes the JAX package's
``scale``, ``weights`` and ``kernel_shift``, and offers T. Chan's circulant
(``_chan_lam``) as an opt-in preconditioner (``_circulant_precond``).
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
from pyxu_tpu_torch.utils.complex import (
    complex_dtype,
    view_as_complex,
    view_as_real,
)
from pyxu_tpu_torch.utils.misc import next_fast_len

__all__ = ["NUFFT", "ES_kernel", "nudft1", "nudft2", "nudft3"]

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
    zq, pw = _es_quad(w, beta)
    ks = np.arange(-(n_modes // 2), (n_modes + 1) // 2)
    c = np.cos(np.outer(ks * alpha, zq))
    return ks, alpha * (c * pw).sum(axis=1) / h


def _es_quad(w: int, beta: float):
    """Gauss-Legendre nodes z_q on [-1, 1] and the weights phi(z_q) w_q of
    the ES kernel's Fourier integrals, q = max(2 w, 24) (host float64)."""
    zq, wq = np.polynomial.legendre.leggauss(max(2 * w, 24))
    return zq, np.exp(beta * (np.sqrt(np.clip(1 - zq ** 2, 0, None)) - 1.0)) \
        * wq


def _cloud(x, device) -> torch.Tensor:
    """(M, d) float64 points on ``device`` (a 1-D input is d = 1)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(device=device, dtype=torch.float64)
    else:
        x = torch.from_numpy(np.array(x, np.float64)).to(device)
    return x[:, None] if x.ndim == 1 else x


def _points(x, device) -> torch.Tensor:
    """(M, d) float64 points on ``device``, folded into [0, 2 pi)."""
    return torch.remainder(_cloud(x, device), 2 * np.pi)


def _plan_dtype(dtype) -> torch.dtype:
    dtype = default_fdtype() if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: want float32 or float64")
    return dtype


def _kernels(d: int):
    """The plan, spread and interp functions of ``d`` dimensions and the path
    they take: the CUDA kernels' wrappers at d = 2 and 3, the plain
    versions at d = 1, which has no kernel."""
    if d == 1:
        return (_kern.plan1, _kern.nufft_spread1_plain,
                _kern.nufft_interp1_plain, "plain")
    if d == 2:
        return _kern.plan2, _kern.nufft_spread2, _kern.nufft_interp2, "kernel"
    if d == 3:
        return _kern.plan3, _kern.nufft_spread3, _kern.nufft_interp3, "kernel"
    raise ValueError(f"d = {d}: the NUFFT takes d = 1, 2 or 3")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mode_grid_flat(N) -> np.ndarray:
    """(prod(N), d) centred integer mode grid, row-major."""
    A = np.meshgrid(*[np.arange(-(n // 2), (n - 1) // 2 + 1) for n in N],
                    indexing="ij")
    return np.stack(A, axis=0).reshape((len(N), -1)).T


def _unit_mesh(N, dtype) -> np.ndarray:
    """(*N, d) centred integer grid."""
    axes = [np.arange(-(n // 2), (n - 1) // 2 + 1, dtype=dtype) for n in N]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


_CHUNKED_ONLY = ("{}() only applies to chunked type-3 transforms "
                 "(NUFFT.type3(..., chunked=True)).")


class _NUFFTDiagnostics:
    """Plan introspection shared by the NUFFT operators: ``params``,
    ``plot_kernel``, ``mesh`` and ``ascomplexarray`` (host numpy).
    ``auto_chunk``, ``allocate``, ``diagnostic_plot`` and ``stats`` belong
    to the chunked type 3 and raise elsewhere."""

    def params(self) -> NUFFT_PARAMS:
        """The plan's parameters (type 3: the rescale per axis as
        ``dilation_factor``)."""
        gamma = getattr(self, "_gamma", None)
        return NUFFT_PARAMS(
            upsample_factor=getattr(self, "_upsampfac", 2.0),
            kernel_width=self._w, kernel_beta=self._beta,
            fft_shape=tuple(self._nf),
            dilation_factor=None if gamma is None else tuple(
                float(g) for g in gamma))

    def plot_kernel(self, ax=None, **kwargs):
        """Plot the spreading kernel of each axis on its support (needs
        matplotlib, imported here)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        z = np.linspace(-1, 1, 100)
        for dd, n in zip(range(self._d), self._nf):
            x = z / (np.pi * self._w / n)
            ax.plot(x, ES_kernel(x, self._beta), label=rf"$\phi_{dd}$",
                    **kwargs)
        if self._d > 1:
            ax.legend()
        return ax

    def auto_chunk(self, max_mem=10, max_anisotropy=5):
        raise NotImplementedError(_CHUNKED_ONLY.format("auto_chunk"))

    def allocate(self, x_chunks, z_chunks, direct_eval_threshold=10_000):
        raise NotImplementedError(_CHUNKED_ONLY.format("allocate"))

    def diagnostic_plot(self, domain: str = "x"):
        raise NotImplementedError(_CHUNKED_ONLY.format("diagnostic_plot"))

    def stats(self):
        raise NotImplementedError(_CHUNKED_ONLY.format("stats"))

    def mesh(self, dtype=None, scale: str = "unit",
             upsampled: bool = False) -> np.ndarray:
        """(N1, ..., Nd, d) grid of the modes (or of the fine grid):
        ``scale`` "unit", the integer mode indices, or "source", the n DFT
        sample positions over [-pi, pi) per axis."""
        dtype = np.float64 if dtype is None else dtype
        N = tuple(self._nf) if upsampled else tuple(self._N)
        if scale == "unit":
            return _unit_mesh(N, dtype)
        if scale == "source":
            axes = [np.linspace(-np.pi, np.pi, num=n, endpoint=False,
                                dtype=dtype) for n in N]
            return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        raise ValueError(f"scale={scale!r}")

    def ascomplexarray(self, dtype=None) -> np.ndarray:
        """The transform's dense complex matrix (host numpy, float64
        points): type 1 (prod(N), M), type 2 (M, prod(N)), type 3 (K, M)."""
        dtype = np.complex128 if dtype is None else dtype
        return self._dense_complex().astype(dtype)


# ------------------------------------------------------------ type 1 / 2 ---

class _NUFFT12(_NUFFTDiagnostics, LinOp):
    r"""Type-1 operator (nonuniform points -> uniform modes); type 2 is its
    adjoint.

    type 1, isign s:  f_k = sum_j c_j exp(s i <k, x_j>),  k in modes(N)
    type 2 (adjoint, isign -s): c_j = sum_k f_k exp(-s i <k, x_j>)

    Real view: dim (M, 2) (``(M,)`` with ``real_in``), codim (*N, 2).
    d = 1 runs the plain spread and interp on either device
    (``kernel_path`` "plain").
    """

    def __init__(self, x, N, isign: int = +1, eps: float = 1e-6,
                 real_in: bool = False, upsampfac: float = 2.0, dtype=None,
                 device=None):
        dev = resolve_device(device, like=x)
        dtype = _plan_dtype(dtype)
        with _span("points"):
            xh = _points(x, dev)
        M, d = xh.shape
        N = (N,) * d if isinstance(N, (int, np.integer)) else tuple(
            int(n) for n in N)
        if len(N) != d:
            raise ValueError(f"N = {N} does not match the points' d = {d}")
        plan, self._spread, self._interp, self.kernel_path = _kernels(d)
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
        with _span("plan"):
            self._plan = plan(xh, self._nf, w, beta, dtype)
        super().__init__((M,) if real_in else (M, 2), N + (2,))
        self._lipschitz = float(np.sqrt(np.prod(N) * M))
        self._name = f"NUFFT1[d={d}]"

    def _dense_complex(self) -> np.ndarray:
        """(prod(N), M) type-1 matrix exp(i s <k, x_j>)."""
        return np.exp(1j * self._isign
                      * (_mode_grid_flat(self._N) @ _host(self._xh).T))

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


class _NUFFT2(_NUFFTDiagnostics, LinOp):
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

    # the plan's introspection is its type-1 pair's
    _w = property(lambda self: self._t1op._w)
    _beta = property(lambda self: self._t1op._beta)
    _nf = property(lambda self: self._t1op._nf)
    _N = property(lambda self: self._t1op._N)
    _d = property(lambda self: self._t1op._d)
    _upsampfac = property(lambda self: self._t1op._upsampfac)

    def _dense_complex(self) -> np.ndarray:
        """(M, prod(N)) type-2 matrix: the conjugate transpose of its pair's
        (planned with the opposite isign)."""
        return self._t1op._dense_complex().conj().T

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

    _chan_cache = None

    def _chan_lam(self) -> torch.Tensor:
        """T. Chan's optimal circulant of the Toeplitz section: its spectrum
        on the mode grid N (standard FFT order, the kernel's dtype),
        computed once and cached.

        Per axis the circulant's kernel averages the wrapped diagonals with
        triangular weights, ``c_j = ((n - j) T[j] + j T[j - n]) / n``, the
        circulant closest to the section in the Frobenius norm (T. Chan
        1988), applied axis by axis in d-D.  Clipped at 0, so that ``I +
        alpha C`` stays positive definite for every alpha >= 0.  A shifted
        (Hankel) kernel is not Toeplitz: ValueError."""
        if self._spec_complex:
            raise ValueError("a shifted (Hankel) kernel has no circulant "
                             "approximation")
        if self._chan_cache is not None:
            return self._chan_cache
        that = self._that
        c = torch.fft.ifftn(that.to(complex_dtype(that.dtype)))
        np_dt = np.float32 if that.dtype == torch.float32 else np.float64
        for ax, n in enumerate(self._N):
            pos = torch.arange(n, device=that.device)
            neg = torch.remainder(pos - n, c.shape[ax])
            w = torch.from_numpy(((n - np.arange(n)) / n).astype(np_dt)).to(
                that.device)
            shape = [1] * c.ndim
            shape[ax] = n
            c = (c.index_select(ax, pos) * w.reshape(shape)
                 + c.index_select(ax, neg) * (1.0 - w).reshape(shape))
        self._chan_cache = torch.clamp(torch.fft.fftn(c).real, min=0.0)
        return self._chan_cache

    def _circulant_precond(self):
        """``solve(r, alpha)``, which applies ``(I + alpha C)^{-1}`` with
        C the Chan circulant of :meth:`_chan_lam` (one FFT pair on the mode
        grid), or None for a shifted kernel.

        Opt in only, as ``quad._prox_precond = A.gram()._circulant_precond()``
        (:meth:`QuadraticFunc.prox` reads it): the JAX package measured
        circulant-preconditioned CG slower than plain CG on scattered-point
        kernels, whose ~sqrt(M) noise at every lag the circulant misses."""
        if self._spec_complex:
            return None
        lam = self._chan_lam()
        dims = tuple(range(-self._d, 0))

        def _inv(c, alpha):
            den = 1.0 + alpha * lam.to(c.real.dtype)
            return torch.fft.ifftn(torch.fft.fftn(c, dim=dims) / den,
                                   dim=dims)

        if self._real_in:
            def solve(r, alpha):
                return _inv(r, alpha).real.to(r.dtype).contiguous()
        else:
            def solve(r, alpha):
                return view_as_real(_inv(view_as_complex(r), alpha)).to(
                    r.dtype)
        return solve


# ----------------------------------------------------------------- type 3 --

def _t3_dx_axes(nf, w: int, beta: float) -> list:
    """Per axis, 1 / psihat2 over the n grid points centred on the ring
    (psi2 is the unit-spacing frequency kernel; host float64, n each): the
    factors of the JAX package's spatial pre-deconvolution grid
    (``_t3_dx_np``, their outer product)."""
    zq, pw = _es_quad(w, beta)
    out = []
    for n in nf:
        xm = np.mod(np.arange(n) * (2 * np.pi / n) + np.pi, 2 * np.pi) - np.pi
        c = np.cos(np.outer(xm * (w / 2.0), zq))
        out.append(1.0 / ((w / 2.0) * (c * pw).sum(axis=1)))
    return out


def _t3_geometry(xmin, xmax, zmin, zmax, w: int):
    """The type-3 plan's centres xm and zm, rescale gamma and least fine
    grid per axis from the clouds' bounds (host float64).  Rounding is
    monotone, so the largest |x - xm| and |z - zm| over the points are the
    bounds', as the JAX package finds them over the points."""
    xm = 0.5 * (xmax + xmin)
    zm = 0.5 * (zmax + zmin)
    gamma = 2.0 * np.maximum(np.maximum(xmax - xm, xm - xmin), 1e-9) / np.pi
    smax = np.maximum(zmax - zm, zm - zmin) * gamma
    nf = tuple(max(next_fast_len(int(4 * (sm + w + 2))), 4 * w + 8)
               for sm in smax)
    return xm, zm, gamma, nf


def _t3_nf_np(xb, zb, w):
    """The fine grid a :class:`_NUFFT3` plan picks for the clouds (xb, zb)
    (host numpy): the chunked planner budgets FFT memory with it without
    building plans."""
    return _t3_geometry(xb.min(axis=0), xb.max(axis=0), zb.min(axis=0),
                        zb.max(axis=0), w)[3]


class _NUFFT3(_NUFFTDiagnostics, LinOp):
    r"""Type 3: f_k = sum_j c_j exp(s i <z_k, x_j>) for points x_j and
    frequencies z_k anywhere in R^d (d = 1, 2, 3).

    The JAX package's plan (FINUFFT's type 3, Barnett et al. 2019, sec.
    3.3).  Both clouds are centred on their midpoints xm, zm, so the
    transform is a core one wrapped in a pre-phase exp(i s <zm, x_j>) on c
    and a post-phase exp(i s <z_k - zm, xm>) on f.  The core rescales x' =
    (x - xm) / gamma, gamma = 2 max|x - xm| / pi, so that x' fills half of
    the ring, [-pi/2, pi/2], and s' = s (z - zm) gamma; it spreads c at x'
    onto the fine grid nf (spacing 2 pi / nf), divides by psihat2 over the
    grid (``dx``), takes the unnormalised inverse FFT, interpolates at s'
    on the unit-spacing ring and divides by psihat1(s') (``ds``).  The
    adjoint runs the transposed steps.  Per axis nf is at least
    ``next_fast_len(4 (max|s'| + w + 2))`` and ``4 w + 8``; ``nf`` may
    raise it.

    Both clouds go through the type-1/2 plans and kernels
    (:mod:`pyxu_tpu_torch.ops.nufft`): x' folded into [0, 2 pi), and s' as
    ``2 pi s' / nf`` folded, so that the plan's left tap ``ceil(s' - w/2)``
    is the JAX package's.  Where ``s' - w/2`` lies within rounding of an
    integer the two may pick taps one cell apart; the tap that moves weighs
    ~exp(-beta) (~1e-7 at w = 7), below the tolerances the transform is
    held to.  ``kernel_path``: "kernel" at d = 2 and 3 (a CUDA input
    launches the kernels or raises), "plain" at d = 1.

    The set-up runs on the points' device in float64, with one host read:
    the clouds' bounds, from which nf (a shape) follows.  ``dx`` stays per
    axis and is multiplied in by broadcasting, the leading axes' product
    (a table of n_1 ... n_{d-1}) and then the last axis, never as a full
    grid; ``ds`` takes K x q cosines an axis.  The JAX package's ``mm3``
    (its TPU slab plans) and ``dx`` (a precomputed grid) options have no
    counterpart.
    """

    def __init__(self, x, z, isign: int = +1, eps: float = 1e-6,
                 real_in: bool = False, nf: tuple = None, dtype=None,
                 device=None):
        dev = resolve_device(device, like=x if isinstance(x, torch.Tensor)
                             else z)
        dtype = _plan_dtype(dtype)
        with _span("points"):
            x, z = _cloud(x, dev), _cloud(z, dev)
        (M, d), (K, dz) = x.shape, z.shape
        if d != dz:
            raise ValueError(f"points of d = {d}, frequencies of d = {dz}")
        plan, self._spread, self._interp, self.kernel_path = _kernels(d)
        w, beta = _es_params(eps)
        self._M, self._K, self._d = M, K, d
        self._isign = int(np.sign(isign)) or 1
        self._w, self._beta, self._eps = w, beta, float(eps)
        self._real_in = bool(real_in)
        self._dtype = dtype
        with _span("bounds read"):
            xm, zm, gamma, nf_min = _t3_geometry(*_host(torch.stack(
                [x.amin(0), x.amax(0), z.amin(0), z.amax(0)])), w)
        nf = nf_min if nf is None else tuple(int(n) for n in nf)
        if len(nf) != d or any(a < b for a, b in zip(nf, nf_min)):
            raise ValueError(f"nf = {nf}: want {d} sides of at least "
                             f"{nf_min}")
        self._nf, self._gamma = nf, gamma
        s = float(self._isign)
        xm, zm, gamma = (torch.from_numpy(v).to(dev) for v in (xm, zm, gamma))
        with _span("phases"):
            cdt = complex_dtype(dtype)
            self._ph_x = torch.exp(1j * s * (x @ zm)).to(cdt)
            self._ph_z = torch.exp(1j * s * ((z - zm) @ xm)).to(cdt)
        sp = (z - zm) * s * gamma
        with _span("plans"):
            self._plan_x = plan(torch.remainder((x - xm) / gamma, 2 * np.pi),
                                nf, w, beta, dtype)
            ring = torch.tensor(nf, dtype=torch.float64, device=dev)
            self._plan_s = plan(torch.remainder(2 * np.pi * sp / ring,
                                                2 * np.pi), nf, w, beta, dtype)
        with _span("dx"):
            f = [torch.from_numpy(v).to(dev) for v in _t3_dx_axes(nf, w, beta)]
            lead = None
            for v in f[:-1]:
                lead = v if lead is None else lead[..., None] * v
            self._dx_lead = None if lead is None else lead.to(dtype)
            self._dx_last = f[-1].to(dtype)
        with _span("ds"):
            zq, pw = (torch.from_numpy(v).to(dev) for v in _es_quad(w, beta))
            ds = torch.ones(K, dtype=torch.float64, device=dev)
            for ax in range(d):
                h = 2 * np.pi / nf[ax]
                alpha = w * h / 2.0
                c = torch.cos(torch.outer(sp[:, ax] * alpha, zq))
                ds = ds * (1.0 / (alpha * (c @ pw) / h))
            self._ds = ds.to(dtype)
        self._x, self._z = x, z
        self._dims = tuple(range(1, d + 1))
        super().__init__((M,) if real_in else (M, 2), (K, 2))
        self._lipschitz = float(np.sqrt(M * K))
        self._name = f"NUFFT3[d={d}]"

    def _mul_dx(self, g):
        """g (B, *nf) complex, a fresh tensor, times the pre-deconvolution
        grid, in place: two broadcast passes."""
        if self._dx_lead is not None:
            g.mul_(self._dx_lead.unsqueeze(-1))
        g.mul_(self._dx_last)
        return g

    def _fw(self, c):
        """Strengths (B, M) complex -> values (B, K) complex."""
        c = c * self._ph_x
        with _span("spread"):
            g = self._spread(view_as_real(c).contiguous(), self._plan_x)
        g = self._mul_dx(view_as_complex(g))
        with _span("fft"):
            # the ring's spectrum with e^{+i q m h}: the unnormalised
            # inverse FFT (isign is folded into s')
            ghat = torch.fft.ifftn(g, dim=self._dims, norm="forward")
        with _span("interp"):
            v = self._interp(view_as_real(ghat), self._plan_s)
        return view_as_complex(v) * self._ds * self._ph_z

    def _bw(self, f):
        """Values (B, K) complex -> strengths (B, M) complex: the adjoint."""
        f = f * self._ph_z.conj() * self._ds
        with _span("spread"):
            ghat = self._spread(view_as_real(f).contiguous(), self._plan_s)
        with _span("fft"):
            g = torch.fft.fftn(view_as_complex(ghat), dim=self._dims)
        with _span("interp"):
            v = self._interp(view_as_real(self._mul_dx(g)), self._plan_x)
        return view_as_complex(v) * self._ph_x.conj()

    def apply(self, arr):
        if self._real_in:
            def single(a):
                return view_as_real(self._fw(view_as_complex(
                    torch.stack([a, torch.zeros_like(a)], dim=-1))))
            return self._map_batched(single, arr, 1, self.codim_shape)

        def single(a):
            return view_as_real(self._fw(view_as_complex(a)))
        return self._map_batched(single, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        def single(a):
            c = view_as_real(self._bw(view_as_complex(a)))
            return c[..., 0] if self._real_in else c
        return self._map_batched(single, arr, 2, self.dim_shape)

    def _dense_complex(self) -> np.ndarray:
        """(K, M) type-3 matrix exp(i s <z_k, x_j>)."""
        return np.exp(1j * self._isign * (_host(self._z) @ _host(self._x).T))

    def mesh(self, dtype=None, scale: str = "unit",
             upsampled: bool = False) -> np.ndarray:
        """The fine grid: "unit", its integer indices; "source" or
        "target", the same mapped onto the points' or the frequencies'
        bounding box."""
        return _t3_mesh(self._nf, _host(self._x), _host(self._z), dtype,
                        scale)


def _t3_mesh(nf, x, z, dtype, scale):
    """A type-3 fine grid, as integer indices or mapped onto the bounding
    box of the points ``x`` or the frequencies ``z`` (host numpy)."""
    dtype = np.float64 if dtype is None else dtype
    grid = _unit_mesh(tuple(nf), dtype)
    if scale == "unit":
        return grid
    if scale not in ("source", "target"):
        raise ValueError(f"scale={scale!r}")
    pts = x if scale == "source" else z
    c = 0.5 * (pts.max(axis=0) + pts.min(axis=0))
    hw = np.maximum(0.5 * (pts.max(axis=0) - pts.min(axis=0)), 1e-9)
    return grid / (np.asarray(nf, dtype) / 2.0) * hw + c


# ------------------------------------------------- chunked type 3 (host) --
# The partition is the JAX package's, in host numpy, so that the blocks'
# index lists, stats() and params() are its own for the same points.

def _norm_widths_np(pts, idx, X):
    """A block's data-box widths over the whole domain's, per axis (NaN
    where the domain has no width)."""
    if len(idx) == 0:
        return None
    w = pts[idx].max(axis=0) - pts[idx].min(axis=0)
    X = np.asarray(X, np.float64)
    out = np.full(w.shape, np.nan)
    ok = X > 1e-12
    out[ok] = w[ok] / X[ok]
    return out


def _block_aniso_np(r):
    """max/min of the valid (finite, non-zero) normalised widths."""
    if r is None:
        return 1.0
    v = r[np.isfinite(r) & (r > 1e-12)]
    if len(v) < 2:
        return 1.0
    return float(v.max() / v.min())


def _mid_split_np(pts, idx, ax):
    """Split a block at the midpoint of its data box along ``ax``."""
    lo, hi = pts[idx, ax].min(), pts[idx, ax].max()
    sel = pts[idx, ax] <= 0.5 * (lo + hi)
    return idx[sel], idx[~sel]


def _widest(r):
    return int(np.nanargmax(np.where(np.isfinite(r), r, -np.inf)))


def _enforce_anisotropy_np(pts, parts, alpha, max_blocks=4096):
    """Every block's normalised shape ratio <= alpha: midpoint splits along
    the widest normalised axis; empty halves are dropped."""
    out = []
    work = [np.asarray(p, np.int64) for p in parts if len(p)]
    X = pts.max(axis=0) - pts.min(axis=0)
    guard = 0
    while work and guard < 10 * max_blocks:
        guard += 1
        idx = work.pop()
        r = _norm_widths_np(pts, idx, X)
        if (_block_aniso_np(r) <= alpha or len(idx) <= 1
                or len(out) + len(work) >= max_blocks):
            out.append(idx)
            continue
        a, b = _mid_split_np(pts, idx, _widest(r))
        if len(a) == 0 or len(b) == 0:
            out.append(idx)
            continue
        work.extend([a, b])
    return out + work


def _enforce_cross_anisotropy_np(xh, x_parts, zh, z_parts, alpha,
                                 max_blocks=4096):
    """x-block widths against z-block widths (normalised, every pair of
    axes) within alpha: the block holding the widest normalised axis is
    split at its midpoint until the ratio fits or the block budget is
    spent (best effort)."""
    Xx = xh.max(axis=0) - xh.min(axis=0)
    Xz = zh.max(axis=0) - zh.min(axis=0)

    def extremes(pts, parts, X):
        """((block, axis, width) of the widest, the narrowest width)."""
        best, mn = None, np.inf
        for i, p in enumerate(parts):
            r = _norm_widths_np(pts, p, X)
            if r is None:
                continue
            v = r[np.isfinite(r) & (r > 1e-12)]
            if len(v) == 0:
                continue
            mn = min(mn, float(v.min()))
            ax = _widest(r)
            if best is None or r[ax] > best[2]:
                best = (i, ax, float(r[ax]))
        return best, mn

    for _ in range(64):
        bx, mnx = extremes(xh, x_parts, Xx)
        bz, mnz = extremes(zh, z_parts, Xz)
        if bx is None or bz is None:
            break
        viol = max(bx[2] / mnz if np.isfinite(mnz) else 1.0,
                   bz[2] / mnx if np.isfinite(mnx) else 1.0)
        if viol <= alpha or len(x_parts) + len(z_parts) >= max_blocks:
            break
        pts, parts, (i, ax, _) = ((xh, x_parts, bx) if bx[2] >= bz[2]
                                  else (zh, z_parts, bz))
        a, b = _mid_split_np(pts, parts[i], ax)
        if len(a) == 0 or len(b) == 0:
            break
        parts[i:i + 1] = [a, b]
    return x_parts, z_parts


def _median_split_np(pts, idx):
    """A block cut at the median of its widest axis (unsplit when it holds
    at most 8 points or a half would be empty)."""
    if len(idx) <= 8:
        return [idx]
    ax = int(np.argmax(pts[idx].max(axis=0) - pts[idx].min(axis=0)))
    med = np.median(pts[idx, ax])
    lo, hi = idx[pts[idx, ax] <= med], idx[pts[idx, ax] > med]
    return [idx] if len(lo) == 0 or len(hi) == 0 else [lo, hi]


def _partition_np(xh, zh, w, itemsize, mem_mb, blk_cap):
    """x and z index lists such that every block's fine grid takes at most
    ``mem_mb`` MB, or the blocks number ``blk_cap``: the side with fewer
    parts is cut at medians, at most five times."""
    x_parts, z_parts = [np.arange(len(xh))], [np.arange(len(zh))]
    for _ in range(5):
        worst = max(np.prod(_t3_nf_np(xh[ip], zh[iq], w)) * itemsize / 1e6
                    for ip in x_parts for iq in z_parts)
        if worst <= mem_mb or len(x_parts) * len(z_parts) >= blk_cap:
            break
        if len(x_parts) <= len(z_parts):
            x_parts = [p for ip in x_parts for p in _median_split_np(xh, ip)]
        else:
            z_parts = [p for iq in z_parts for p in _median_split_np(zh, iq)]
    return x_parts, z_parts


class _NUFFT3Chunked(_NUFFTDiagnostics, LinOp):
    r"""Type 3 on a partition of both clouds: the points into P blocks and
    the frequencies into Q by median bisection (host numpy), each pair (q,
    p) with its own :class:`_NUFFT3` on a grid that scales with the pair's
    own space-bandwidth product, and ``f[q] = sum_p A_qp c[p]``.  The
    partition keeps every block's fine grid within ``fft_mem_mb`` MB (8
    bytes a cell at float32, 16 at float64) or stops at ``max_blocks``
    blocks.  ``apply`` and ``adjoint`` loop the blocks with
    ``index_select`` / ``index_copy_`` on the device.  Complex input only.
    """

    def __init__(self, x, z, isign: int = +1, eps: float = 1e-6,
                 fft_mem_mb: float = 64.0, max_blocks: int = 16, dtype=None,
                 device=None):
        dev = resolve_device(device, like=x if isinstance(x, torch.Tensor)
                             else z)
        self._dtype = _plan_dtype(dtype)
        x, z = _cloud(x, dev), _cloud(z, dev)
        (M, d), (K, _) = x.shape, z.shape
        super().__init__((M, 2), (K, 2))
        self._xd, self._zd = x, z
        self._xh, self._zh = _host(x), _host(z)
        self._isign, self._eps = int(isign), float(eps)
        self._itemsize = 8 if self._dtype == torch.float32 else 16
        self._rebuild(*_partition_np(self._xh, self._zh, _es_params(eps)[0],
                                     self._itemsize, fft_mem_mb, max_blocks))
        self._lipschitz = float(np.sqrt(M * K))

    def _rebuild(self, x_parts, z_parts):
        """The (q, p) blocks' plans from the two index lists."""
        dev = self._xd.device
        self._x_parts = tuple(tuple(int(i) for i in p) for p in x_parts)
        self._z_parts = tuple(tuple(int(i) for i in p) for p in z_parts)
        self._x_idx = [torch.tensor(p, dtype=torch.int64, device=dev)
                       for p in self._x_parts]
        self._z_idx = [torch.tensor(p, dtype=torch.int64, device=dev)
                       for p in self._z_parts]
        self._blocks = tuple(
            tuple(_NUFFT3(self._xd.index_select(0, ip),
                          self._zd.index_select(0, iq), isign=self._isign,
                          eps=self._eps, dtype=self._dtype, device=dev)
                  for ip in self._x_idx)
            for iq in self._z_idx)
        self.kernel_path = self._blocks[0][0].kernel_path
        self._name = (f"NUFFT3Chunked[{len(self._x_parts)}x"
                      f"{len(self._z_parts)}]")

    def auto_chunk(self, max_mem=10, max_anisotropy=5):
        """(x_chunks, z_chunks) index lists that meet a per-block FFT
        memory of ``max_mem`` MB under an anisotropy cap: the median
        bisection, then midpoint splits along each offending block's widest
        normalised axis, within a domain and across the two.  Splits are
        dyadic, so caps below 1.5 are raised to 1.5."""
        alpha = max(1.5, float(max_anisotropy))
        x_parts, z_parts = _partition_np(self._xh, self._zh,
                                         _es_params(self._eps)[0],
                                         self._itemsize, float(max_mem), 4096)
        x_parts = _enforce_anisotropy_np(self._xh, x_parts, alpha)
        z_parts = _enforce_anisotropy_np(self._zh, z_parts, alpha)
        x_parts, z_parts = _enforce_cross_anisotropy_np(
            self._xh, x_parts, self._zh, z_parts, alpha)
        return ([np.asarray(p, np.int64) for p in x_parts],
                [np.asarray(p, np.int64) for p in z_parts])

    def allocate(self, x_chunks, z_chunks, direct_eval_threshold=10_000):
        """Plan again on the given index lists, which must partition
        ``range(M)`` and ``range(K)`` (ValueError otherwise).
        ``direct_eval_threshold`` (FINUFFT's direct sum for tiny blocks) is
        accepted and has no effect."""
        del direct_eval_threshold
        M, K = self.dim_shape[0], self.codim_shape[0]
        for chunks, n, dom in ((x_chunks, M, "x"), (z_chunks, K, "z")):
            seen = np.concatenate([np.asarray(c).ravel() for c in chunks])
            if not (len(seen) == n and np.array_equal(np.sort(seen),
                                                      np.arange(n))):
                raise ValueError(
                    f"{dom}_chunks must partition range({n}) exactly")
        self._rebuild([np.asarray(c, np.int64).ravel() for c in x_chunks],
                      [np.asarray(c, np.int64).ravel() for c in z_chunks])
        return self

    # the first block's plan answers the mixin's introspection
    _w = property(lambda self: self._blocks[0][0]._w)
    _beta = property(lambda self: self._blocks[0][0]._beta)
    _nf = property(lambda self: self._blocks[0][0]._nf)
    _d = property(lambda self: self._blocks[0][0]._d)

    def _dense_complex(self) -> np.ndarray:
        return np.exp(1j * self._blocks[0][0]._isign
                      * (self._zh @ self._xh.T))

    def mesh(self, dtype=None, scale: str = "unit",
             upsampled: bool = False) -> np.ndarray:
        """"unit": the first block's fine grid; "source" / "target": the
        same mapped onto the whole clouds' bounding boxes."""
        return _t3_mesh(self._nf, self._xh, self._zh, dtype, scale)

    def stats(self) -> dict:
        """The partition: block counts and sizes."""
        return {
            "n_x_blocks": len(self._x_parts),
            "n_z_blocks": len(self._z_parts),
            "x_block_sizes": [len(p) for p in self._x_parts],
            "z_block_sizes": [len(p) for p in self._z_parts],
        }

    def params(self) -> dict:
        """Per (z block, x block): its fine grid, w, M and K."""
        return {
            (qi, pi): {"n_fine": blk._nf, "w": blk._w,
                       "M": len(self._x_parts[pi]),
                       "K": len(self._z_parts[qi])}
            for qi, row in enumerate(self._blocks)
            for pi, blk in enumerate(row)
        }

    def diagnostic_plot(self, domain: str = "x"):
        """Scatter one domain's points coloured by block (needs matplotlib,
        imported here); returns the Figure."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if domain not in ("x", "z"):
            raise ValueError(f"domain={domain!r}: want 'x' or 'z'")
        parts = self._x_parts if domain == "x" else self._z_parts
        cloud = self._xh if domain == "x" else self._zh
        fig, ax = plt.subplots(figsize=(5, 4))
        for bi, idx in enumerate(parts):
            p = cloud[list(idx)]
            ax.scatter(p[:, 0], p[:, 1] if p.shape[1] > 1 else
                       np.zeros(len(p)), s=4, label=f"block {bi}")
        ax.set_title(f"NUFFT3 chunked partition ({domain}-domain, "
                     f"{len(parts)} blocks)")
        ax.legend(fontsize=6, markerscale=2)
        return fig

    def apply(self, arr):
        def single(a):
            out = a.new_empty((a.shape[0],) + self.codim_shape)
            for row, iq in zip(self._blocks, self._z_idx):
                acc = sum(blk.apply(a.index_select(1, ip))
                          for blk, ip in zip(row, self._x_idx))
                out.index_copy_(1, iq, acc)
            return out
        return self._map_batched(single, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        def single(a):
            out = a.new_empty((a.shape[0],) + self.dim_shape)
            for pi, ip in enumerate(self._x_idx):
                acc = sum(row[pi].adjoint(a.index_select(1, iq))
                          for row, iq in zip(self._blocks, self._z_idx))
                out.index_copy_(1, ip, acc)
            return out
        return self._map_batched(single, arr, 2, self.dim_shape)


# ----------------------------------------------------------- public API ----

class NUFFT:
    """Factory namespace: ``NUFFT.type1``, ``NUFFT.type2`` and
    ``NUFFT.type3`` for d = 1, 2 and 3.

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
              chunked: bool = False, fft_mem_mb: float = 64.0,
              max_blocks: int = 16, dtype=None, device=None, **plan_kwargs):
        """``chunked=True``: the partitioned plan, every block's fine grid
        within ``fft_mem_mb`` MB or at most ``max_blocks`` blocks
        (:class:`_NUFFT3Chunked`; complex input only)."""
        _ignore_finufft_kwargs(plan_kwargs)
        if chunked:
            if real:
                raise ValueError("the chunked type 3 takes complex input only")
            return _NUFFT3Chunked(x, z, isign=isign, eps=eps,
                                  fft_mem_mb=fft_mem_mb,
                                  max_blocks=max_blocks, dtype=dtype,
                                  device=device)
        return _NUFFT3(x, z, isign=isign, eps=eps, real_in=real, dtype=dtype,
                       device=device)


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


def nudft3(c, x, z, isign=+1):
    """Direct type 3: f_k = sum_j c_j e^{isign i <z_k, x_j>} (host
    numpy)."""
    x = np.asarray(x, np.float64)
    z = np.asarray(z, np.float64)
    x = x[:, None] if x.ndim == 1 else x
    z = z[:, None] if z.ndim == 1 else z
    return np.exp(1j * isign * (z @ x.T)) @ np.asarray(c)
