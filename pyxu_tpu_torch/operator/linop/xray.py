r"""Parallel-beam 2-D X-ray (Radon) transforms (counterpart of
``pyxu_tpu/operator/linop/xray.py``).

* :class:`RadonTransform` — line integrals by bilinear sampling along the
  rays, the rule of ``map_coordinates(order=1, mode="constant", cval=0)``:
  each of a sample's four neighbours weighted by the two axes' linear
  weights and dropped on its own where it lies outside the image.  As in
  the JAX package, no table is stored: each apply computes the samples'
  coordinates on the operator's device, a block of views at a time; the
  apply is a gather and a sum, the adjoint its exact transpose by
  ``index_add_``.
* :class:`FourierRadon` — the same transform by the Fourier-slice
  theorem: one 2-D type-2 NUFFT at the polar frequencies of the detector
  bins (through the port's spread and interp kernels), a phase for the
  detector's centre and an inverse FFT along each projection.  Its
  :meth:`~FourierRadon.gram` is FFTs only: a weighted Toeplitz section
  less, for an even detector, a shifted Hankel section of the Nyquist bins
  (:class:`_FourierRadonGram`).
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp, SelfAdjointOp
from pyxu_tpu_torch.operator.linop.nufft import NUFFT, _NUFFTToeplitz, _span
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.complex import complex_dtype, view_as_complex
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["RadonTransform", "FourierRadon"]


class RadonTransform(LinOp):
    """dim ``(H, W)`` image -> codim ``(n_angles, n_det)`` sinogram.

    Ray ``(theta, t)`` samples the image at ``n_samples`` points ``t
    (cos, sin) + u (-sin, cos)``, ``t`` and ``u`` evenly spaced over the
    image's diagonal, with the array centre at the origin; a projection is
    the sum of its samples times their spacing.  The coordinates are
    computed in float64 in each apply and adjoint, for at most
    ``_CHUNK`` samples (a block of views) at a time, so the transient
    memory is a few hundred bytes a sample of such a block and the
    operator holds only the angles and the two 1-D rulers.  ``device``
    (default ``cuda``) is where they live; ``dtype`` is accepted for the
    other operators' signature: the weights take the input's dtype.
    """

    _CHUNK = 1 << 22          # samples whose coordinates are live at once

    def __init__(self, dim_shape, angles, n_det: int = None,
                 n_samples: int = None, dtype=None, device=None):
        dim_shape = as_canonical_shape(dim_shape)
        H, W = dim_shape
        angles = np.atleast_1d(np.asarray(angles, np.float64))
        n_det = n_det or int(_math.ceil(_math.hypot(H, W)))
        n_samples = n_samples or int(_math.ceil(_math.hypot(H, W)))
        super().__init__(dim_shape, (len(angles), n_det))
        dev = resolve_device(device)
        self._n_angles, self._n_det = len(angles), n_det
        self._n_samples = n_samples
        R = 0.5 * _math.hypot(H, W)

        def f64(v):
            return torch.from_numpy(np.asarray(v, np.float64)).to(dev)
        self._cos, self._sin = f64(np.cos(angles)), f64(np.sin(angles))
        self._t = f64(np.linspace(-R, R, n_det))[:, None]
        self._u = f64(np.linspace(-R, R, n_samples))[None, :]
        self._ds = 2 * R / (n_samples - 1)
        self._views = max(1, self._CHUNK // (n_det * n_samples))
        # L <= sqrt(||A||_1 ||A||_inf): a ray integrates at most the
        # diagonal, a pixel is hit by at most n_angles rays of weight ds
        self._lipschitz = float(
            _math.sqrt((2 * R) * self._n_angles * self._ds * 2))
        self._name = "RadonTransform"

    def _corners(self, a0, a1, dtype, device):
        """The four neighbours of the samples of views ``[a0, a1)``: for
        each, the flat pixel index (0 where it lies outside) and the weight
        (0 there), each ``(a1 - a0, n_det, n_samples)``."""
        H, W = self.dim_shape
        c = self._cos[a0:a1, None, None].to(device)
        s = self._sin[a0:a1, None, None].to(device)
        t, u = self._t.to(device), self._u.to(device)
        rows = (H - 1) / 2.0 + (t * s + u * c)
        cols = (W - 1) / 2.0 + (t * c - u * s)
        for r, wr in self._linear(rows):
            okr = (r >= 0) & (r < H)
            for q, wq in self._linear(cols):
                ok = okr & (q >= 0) & (q < W)
                yield (torch.where(ok, r * W + q, 0),
                       torch.where(ok, wr * wq, 0.0).to(dtype))

    @staticmethod
    def _linear(coord):
        """The two neighbours along one axis and their linear weights."""
        lo = torch.floor(coord)
        w_hi = coord - lo
        lo = lo.long()
        return ((lo, 1.0 - w_hi), (lo + 1, w_hi))

    def _blocks(self):
        return ((a, min(a + self._views, self._n_angles))
                for a in range(0, self._n_angles, self._views))

    def apply(self, arr):
        def fn(x):                                      # (B, H, W)
            B = x.shape[0]
            xf = x.reshape(B, -1)
            out = []
            for a0, a1 in self._blocks():
                acc = 0
                for idx, w in self._corners(a0, a1, x.dtype, x.device):
                    acc = acc + xf[:, idx.reshape(-1)] * w.reshape(-1)
                out.append(acc.reshape(B, a1 - a0, self._n_det, -1).sum(-1))
            return torch.cat(out, 1) * self._ds
        return self._map_batched(fn, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        def fn(y):                                      # (B, A, n_det)
            B = y.shape[0]
            out = y.new_zeros((B, self.dim_size))
            for a0, a1 in self._blocks():
                ys = (y[:, a0:a1, :, None] * self._ds).expand(
                    -1, -1, -1, self._n_samples)
                for idx, w in self._corners(a0, a1, y.dtype, y.device):
                    out.index_add_(1, idx.reshape(-1),
                                   (ys * w).reshape(B, -1))
            return out.reshape((B,) + self.dim_shape)
        return self._map_batched(fn, arr, 2, self.dim_shape)


class FourierRadon(LinOp):
    r"""Parallel-beam Radon transform by the Fourier-slice theorem::

        p_theta(t_m) = (1 / n_det) sum_q phat_theta(w_q) e^{i w_q t_m},
        phat_theta(w) = sum_k f_k e^{-i w <k, (cos theta, sin theta)>},

    with the image's pixels as centred modes ``k``, the detector bins
    ``t_m = m - (n_det - 1) / 2`` one pixel apart and ``w_q`` their DFT
    frequencies in ``fftfreq`` order.  One 2-D type-2 NUFFT at the
    ``n_angles x n_det`` polar points, then the detector-centre phase and
    an inverse FFT along each projection; the adjoint is the conjugate
    pipeline.  ``n_det`` defaults to the power of 2 at or above 1.5 times
    the larger side.  ``dtype`` (default: the precision policy's) and
    ``device`` (default ``cuda``) are the NUFFT plan's.
    """

    def __init__(self, dim_shape, angles, n_det: int = None,
                 eps: float = 1e-6, dtype=None, device=None):
        dim_shape = as_canonical_shape(dim_shape)
        H, W = dim_shape
        angles = np.atleast_1d(np.asarray(angles, np.float64))
        n_det = n_det or int(2 ** _math.ceil(_math.log2(max(H, W) * 1.5)))
        super().__init__(dim_shape, (len(angles), n_det))
        self._n_angles, self._n_det = len(angles), n_det
        q = np.fft.fftfreq(n_det) * 2 * np.pi
        dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        pts = (q[None, :, None] * dirs[:, None, :]).reshape(-1, 2)
        # phat(w) = sum_k f_k e^{-i w k}: a type 2 of isign -1, on real
        # images (its adjoint returns the real part)
        self._nufft = NUFFT.type2(pts, dim_shape, isign=-1, eps=eps,
                                  real=True, dtype=dtype, device=device)
        t1 = self._nufft._t1op
        self.kernel_path = self._nufft.kernel_path
        ct = (n_det - 1) / 2.0
        self._phase = torch.from_numpy(np.exp(-1j * q * ct)).to(
            device=t1._xh.device, dtype=complex_dtype(t1._dtype))
        self._lipschitz = float(_math.sqrt(self._n_angles)
                                * _math.sqrt(H * W))
        self._name = "FourierRadon"

    def _fw(self, img):                                 # (B, H, W)
        B = img.shape[0]
        vis = view_as_complex(self._nufft.apply(img))   # (B, A n_det)
        phat = vis.reshape(B, self._n_angles, self._n_det) * self._phase
        return torch.fft.ifft(phat, dim=-1).real

    def _bw(self, sino):                                # (B, A, n_det)
        phat = torch.fft.fft(sino, dim=-1) * (self._phase.conj()
                                              / self._n_det)
        vis = torch.view_as_real(phat.reshape(sino.shape[0], -1))
        return self._nufft.adjoint(vis)

    def apply(self, arr):
        return self._map_batched(self._fw, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        return self._map_batched(self._bw, arr, 2, self.dim_shape)

    def gram(self) -> "_FourierRadonGram":
        r"""``R^T R`` as FFT-only circulant convolutions: no spread or
        interp an apply.

        With ``R = Re(G A)``, ``G`` the phase and the row IFFT and ``A`` the
        type-2 NUFFT, for real x ``R^T R x = [Re(A^H G^H G A x) + Re(A^H
        G^H conj(G A x))] / 2``.  ``G^H G = I / n_det``, so the first term is
        the ``1/n_det``-scaled Toeplitz kernel of the polar points; in the
        second, ``G^H conj(G .)`` pairs bin q with -q: the pairs give the same
        Toeplitz kernel, and the self-paired Nyquist bin (even ``n_det``)
        gives, with the phase ``e^{-2 i pi c_t} = -1``, a Hankel section over
        the Nyquist points.  So, for an even detector, ``(1/n_det) Re[
        Toeplitz(w_nyq = 1/2) - (1/2) Hankel(nyq)]``, the Hankel section a
        Toeplitz one of kernel shift -1 (on even image axes) applied to the
        flipped input; an odd detector has the Toeplitz term alone.  A new
        operator on each call (two Toeplitz builds for an even detector),
        as in the JAX package.
        """
        return _FourierRadonGram(self)


class _FourierRadonGram(SelfAdjointOp):
    """``R^T R`` of a :class:`FourierRadon` by Toeplitz and Hankel
    sections (see :meth:`FourierRadon.gram`)."""

    def __init__(self, R: FourierRadon):
        super().__init__(R.dim_shape)
        t1 = R._nufft._t1op
        nd, na = R._n_det, R._n_angles
        even = nd % 2 == 0 and nd > 1
        w = np.ones((na, nd))
        if even:
            w[:, nd // 2] = 0.5
        with _span("toeplitz build"):
            self._t = _NUFFTToeplitz(t1._xh, t1._N, t1._isign, t1._eps,
                                     real_in=True, dtype=t1._dtype,
                                     scale=1.0 / nd, weights=w.reshape(-1))
        self._h = None
        if even:
            pts = t1._xh.reshape(na, nd, 2)[:, nd // 2].contiguous()
            # centred modes k(i) = i - n//2 under index reversal: offset
            # (n - 1) - 2 (n//2), -1 on an even image axis, 0 on an odd one
            with _span("hankel build"):
                self._h = _NUFFTToeplitz(
                    pts, t1._N, t1._isign, t1._eps, real_in=True,
                    dtype=t1._dtype, scale=0.5 / nd,
                    kernel_shift=tuple(-1 if n % 2 == 0 else 0
                                       for n in t1._N))
        self._lipschitz = self._t.lipschitz + (
            self._h.lipschitz if self._h is not None else 0.0)
        self._name = "FourierRadonGram"

    def apply(self, arr):
        def fn(x):                                      # (B, H, W)
            y = self._t.apply(x)
            if self._h is not None:
                y = y - self._h.apply(torch.flip(x, (1, 2)))
            return y
        return self._map_batched(fn, arr, 2, self.codim_shape)

    def adjoint(self, arr):
        return self.apply(arr)
