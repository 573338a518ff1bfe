r"""Out-of-core (host-offload) streaming execution (counterpart of
``pyxu_tpu/parallel/outofcore.py``).

State lives in host RAM (numpy, optionally memory-mapped) and row bands
stream through the device one at a time, so device memory holds one band
and its temporaries: the problem size is bounded by host RAM or disk, not
by the card's memory.

- :func:`streamed_map_overlap` applies any *local* function (stencils,
  gradients, elementwise chains; radius <= ``depth``) to a host array band
  by band with halo rows, exactly.
- :func:`streamed_block_diag` applies one operator per host-resident block.
- :class:`StreamedCondatVu` runs a whole TV-deconvolution Condat-Vu solve
  over host-resident state.  Each band update runs on an extended band
  whose halo is wide enough that the written rows equal the *global*
  iteration exactly (not block-Jacobi).

Every band has the same extended shape (edge bands are zero-padded, which
is ``mode="constant"`` global boundary handling).  The bands run one after
the other: a band's host-to-device copy, its compute and its copy back do
not overlap with the next band's.  All three stage their bands in host
buffers that every band of the same shape reuses (:class:`_Staging`):
page-locked where the device is CUDA.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from pyxu_tpu_torch.runtime import resolve_device

__all__ = ["streamed_map_overlap", "streamed_block_diag", "StreamedCondatVu"]


def _band_slices(n: int, block: int):
    return [(s, min(s + block, n)) for s in range(0, n, block)]


def _fill_halo(dst, arr, s, e, depth):
    """Write the zero-padded extended band ``arr[..., s-depth : e+depth, :]``
    along axis -2 into ``dst`` (``(..., block + 2 depth, W)``; rows past
    the domain and past the band's end are zeros): the JAX package's
    ``_extract_halo``, into a staging buffer instead of a fresh array."""
    n = arr.shape[-2]
    a, b = max(s - depth, 0), min(e + depth, n)
    off = a - (s - depth)
    dst[..., :off, :] = 0
    dst[..., off:off + b - a, :] = arr[..., a:b, :]
    dst[..., off + b - a:, :] = 0
    return dst


class _Staging:
    """Host buffers for the band copies, one a (name, shape, dtype), reused
    by every band: page-locked where the device is CUDA, so that the copies
    run at the link's rate with no pageable bounce and may be
    ``non_blocking``; plain host memory on the CPU, where a copy to the
    device is the buffer itself.  ``moved`` counts the bytes copied up and
    down.  A buffer is free for the next band after :meth:`sync`."""

    def __init__(self, dev):
        self.dev = dev
        self.pin = dev.type == "cuda"
        self.moved = 0
        self._bufs = {}

    def host(self, name, shape, dtype) -> np.ndarray:
        """The numpy view of buffer ``name`` (``dtype`` a numpy dtype)."""
        dt = torch.from_numpy(np.empty(0, dtype)).dtype
        return self._buffer(name, tuple(shape), dt).numpy()

    def _buffer(self, name, shape, dtype) -> torch.Tensor:
        key = (name, shape, dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=self.pin)
        return buf

    def up(self, a: np.ndarray) -> torch.Tensor:
        """``a`` (a :meth:`host` view) on the device."""
        self.moved += a.nbytes
        return torch.from_numpy(a).to(self.dev, non_blocking=True)

    def down(self, name, t: torch.Tensor) -> np.ndarray:
        """``t`` copied to the host (into buffer ``name`` on CUDA): read it
        after :meth:`sync`, before the next band's :meth:`down`."""
        self.moved += t.nbytes
        if not self.pin:
            return t.numpy()
        buf = self._buffer(name, tuple(t.shape), t.dtype)
        buf.copy_(t, non_blocking=True)
        return buf.numpy()

    def sync(self):
        if self.pin:
            torch.cuda.current_stream(self.dev).synchronize()


def streamed_map_overlap(fn, x, depth: int, block_rows: int = 4096,
                         out_dtype=None, device=None):
    """Apply a local function to a host 2-D array (leading batch axes
    allowed) band by band along axis -2 with ``depth`` halo rows.

    ``fn`` takes and returns a tensor on ``device`` (default ``cuda``); it
    must be shift-invariant with receptive-field radius <= ``depth`` along
    axis -2 and treat out-of-domain rows as zero (``mode="constant"``).
    Every band it sees has the shape ``(..., block + 2 depth, W)``.  The
    result's rows are trimmed and written to a host output array.
    """
    x = np.asarray(x)
    stage = _Staging(resolve_device(device))
    n = x.shape[-2]
    block = min(block_rows, n)
    out = None
    for s, e in _band_slices(n, block):
        xb = stage.host("x", x.shape[:-2] + (block + 2 * depth, x.shape[-1]),
                        x.dtype)
        yb = fn(stage.up(_fill_halo(xb, x, s, e, depth)))
        rows = stage.down("y", yb[..., depth:depth + (e - s), :])
        stage.sync()
        if out is None:
            oshape = rows.shape[:-2] + (n,) + rows.shape[-1:]
            out = np.zeros(oshape, out_dtype or rows.dtype)
        out[..., s:e, :] = rows
    return out


def streamed_block_diag(ops, xs, device=None):
    """Apply ``ops[i]`` to host-resident block ``xs[i]``, one block on the
    device at a time.  Returns host blocks."""
    if len(ops) != len(xs):
        raise ValueError(f"{len(ops)} ops vs {len(xs)} blocks")
    stage = _Staging(resolve_device(device))
    out = []
    for op, xb in zip(ops, xs):
        xb = np.asarray(xb)
        buf = stage.host("x", xb.shape, xb.dtype)
        np.copyto(buf, xb)
        yb = stage.down("y", op.apply(stage.up(buf)))
        stage.sync()
        out.append(np.array(yb))
    return out


class StreamedCondatVu:
    r"""TV-regularized deconvolution (Condat-Vu iteration) over
    host-resident state: the giga-pixel one-card path.

    minimize 0.5||K x - y||^2 + lam ||D x||_{2,1}

    with ``K`` a separable odd correlation kernel (``mode="constant"``)
    and ``D`` the forward-difference gradient.  ``x``, ``z (2, H, W)`` and
    ``y`` are float32 host arrays (pass memmaps for disk-backed problems);
    every iteration streams row bands through ``device`` (default
    ``cuda``).  Each band update runs on an extended band with ``2 radius +
    2`` halo rows, enough that the written rows equal the global in-memory
    iteration exactly.  The band step is the port's ``Stencil`` (the
    stencil kernel on the card, two launches), ``Gradient`` (four) and
    ``L21Norm.fenchel_prox``.

    Device memory high-water: one extended band's x, z, y and temporaries,
    independent of H.  ``bytes_moved`` counts the host-device copies of
    the last :meth:`fit`; ``time_split`` holds, for each of its
    iterations, the host clock's seconds spent staging the bands (halo
    fills into the staging buffers, the mask), on the device (copies up,
    the band step, copies down and the wait for them) and writing the
    rows back to the state.
    """

    def __init__(self, y, k1, lam: float = 0.01, block_rows: int = 4096,
                 tau: float = None, sigma: float = None, device=None):
        self._y = np.ascontiguousarray(np.asarray(y, np.float32))
        self._k1 = np.asarray(k1, np.float32)
        if self._k1.ndim != 1 or len(self._k1) % 2 != 1:
            raise ValueError("k1 must be a 1-D odd-length kernel")
        self._lam = float(lam)
        self._dev = resolve_device(device)
        Ht, W = self._y.shape
        c = (len(self._k1) - 1) // 2
        self._halo = 2 * c + 2      # exactness margin, see class docstring
        # the rolling-tail snapshot (fit) needs each band to cover a full
        # halo of its successor
        self._block = int(min(max(block_rows, self._halo), Ht))
        # Condat-Vu steps: beta = ||K||^2 <= 1 (normalized kernel),
        # ||D||^2 <= 8
        L_D = math.sqrt(8.0)
        self._tau = tau if tau is not None else 1.0 / (0.5 + L_D)
        self._sigma = sigma if sigma is not None else 1.0 / L_D
        self._x = self._y.copy()
        self._z = np.zeros((2, Ht, W), np.float32)
        self._it = 0
        self.bytes_moved = 0
        self.time_split = []
        self._stage = _Staging(self._dev)
        self._step = self._build_step()

    def _build_step(self):
        """The per-band device step, one operator set for every band."""
        from pyxu_tpu_torch.operator.func import L21Norm
        from pyxu_tpu_torch.operator.linop import Gradient, Stencil

        _, W = self._y.shape
        Rh = self._block + 2 * self._halo
        c = (len(self._k1) - 1) // 2
        K = Stencil((Rh, W), [self._k1, self._k1], [c, c], mode="constant")
        D = Gradient((Rh, W), mode="constant")
        h = self._lam * L21Norm((2, Rh, W), l2_axis=0)
        tau, sigma = self._tau, self._sigma

        def step(xb, zb, yb, mask):
            # mask = in-global-domain row indicator (Rh, 1).  The extended
            # band computes K x / xp on out-of-domain halo rows too; the
            # global iteration has no residual or iterate there, so those
            # rows are zeroed before an adjoint or a difference folds them
            # back into in-domain rows.
            r = (K.apply(xb) - yb) * mask
            gf = K.adjoint(r)
            xp = (xb - tau * (gf + D.adjoint(zb))) * mask
            u = D.apply(2.0 * xp - xb)
            zp = h.fenchel_prox(zb + sigma * u, sigma)
            return xp, zp

        return step

    @torch.no_grad()
    def fit(self, n_iters: int = 10):
        Ht, W = self._y.shape
        Hh, block = self._halo, self._block
        Rh = block + 2 * Hh
        stage = self._stage
        stage.moved = 0
        self.time_split = []
        xb, zb, yb = (stage.host(k, shape, np.float32) for k, shape in (
            ("x", (Rh, W)), ("z", (2, Rh, W)), ("y", (Rh, W))))
        mask = stage.host("mask", (Rh, 1), np.float32)
        for _ in range(n_iters):
            # snapshot semantics: band updates read iteration-k state, so
            # in-place writes of already-updated bands must not leak into
            # later bands' halos.  Only the trailing halo rows of the
            # previous band are at risk: keep a rolling copy.
            xs, zs = self._x, self._z
            x_prev_tail = np.zeros((Hh,) + xs.shape[1:], xs.dtype)
            z_prev_tail = np.zeros((2, Hh) + zs.shape[2:], zs.dtype)
            split = dict.fromkeys(("stage", "device", "write_back"), 0.0)
            for bi, (s, e) in enumerate(_band_slices(Ht, block)):
                t0 = time.perf_counter()
                _fill_halo(xb, xs, s, e, Hh)
                _fill_halo(zb, zs, s, e, Hh)
                if bi > 0:                  # restore iteration-k halo rows
                    lo = max(s - Hh, 0)
                    xb[: s - lo] = x_prev_tail[Hh - (s - lo):]
                    zb[:, : s - lo] = z_prev_tail[:, Hh - (s - lo):]
                _fill_halo(yb, self._y, s, e, Hh)
                rows = np.arange(s - Hh, s - Hh + Rh)
                mask[:, 0] = (rows >= 0) & (rows < Ht)
                t1 = time.perf_counter()
                xpb, zpb = self._step(*map(stage.up, (xb, zb, yb, mask)))
                n = e - s
                x_out = stage.down("x_out", xpb[Hh:Hh + n])
                z_out = stage.down("z_out", zpb[:, Hh:Hh + n])
                stage.sync()
                t2 = time.perf_counter()
                # save the rows the next band will need before overwriting
                tail_lo = max(e - Hh, s)
                x_prev_tail[Hh - (e - tail_lo):] = xs[tail_lo:e]
                z_prev_tail[:, Hh - (e - tail_lo):] = zs[:, tail_lo:e]
                xs[s:e] = x_out
                zs[:, s:e] = z_out
                t3 = time.perf_counter()
                split["stage"] += t1 - t0
                split["device"] += t2 - t1
                split["write_back"] += t3 - t2
            self.time_split.append(split)
            self._it += 1
        self.bytes_moved = stage.moved
        return self

    def solution(self) -> np.ndarray:
        return self._x

    @property
    def state_bytes(self) -> int:
        return self._x.nbytes + self._z.nbytes + self._y.nbytes
