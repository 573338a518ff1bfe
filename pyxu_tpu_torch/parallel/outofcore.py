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
is ``mode="constant"`` global boundary handling).  The bands are staged in
host buffers that later bands reuse (:class:`_Staging`): page-locked where
the device is CUDA.  :func:`streamed_map_overlap` and
:func:`streamed_block_diag` keep one band in flight, as the JAX package
does: band i+1 is filled on the host, copied up and computed while band
i's rows come back, and band i is written into the output only after its
copy back is done.  :class:`StreamedCondatVu` runs its bands one after
the other (each band's halo holds rows the band before it wrote).
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
    """Host buffers for the band copies, keyed by (name, slot, shape,
    dtype) and reused by later bands, and the copies between them and the
    device.  ``moved`` counts the bytes copied up and down.

    On CUDA the buffers are page-locked, so that the copies run at the
    link's rate and are asynchronous.  Copies up run on one side stream
    and copies down on another: the compute stream (the current stream,
    where ``fn`` and the kernels run) waits for a band's copy up, and its
    copy down waits for the compute queued before it.  A buffer's copy up
    leaves an event, and :meth:`host` waits on it before the buffer is
    written again.  Device tensors that cross streams are
    ``record_stream``-ed, so that the caching allocator hands out their
    memory only after the other stream is done with them.

    On the CPU the buffers are plain host memory and a band on the
    "device" is its buffer itself: with no queue, every copy is done when
    its call returns."""

    def __init__(self, dev):
        self.dev = dev
        self.pin = dev.type == "cuda"
        self.moved = 0
        self._bufs = {}
        self._busy = {}         # buffer key -> the event of its copy up
        if self.pin:
            self._compute = torch.cuda.current_stream(dev)
            self._up = torch.cuda.Stream(dev)
            self._down = torch.cuda.Stream(dev)

    @staticmethod
    def _key(name, slot, shape, dtype):
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return (name, slot, tuple(shape), dtype)

    def _buffer(self, key) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(key[2], dtype=key[3],
                                                pin_memory=self.pin)
        return buf

    def host(self, name, shape, dtype, slot=0) -> np.ndarray:
        """The numpy view of buffer (``name``, ``slot``), free to write:
        its last copy up is done."""
        key = self._key(name, slot, shape, dtype)
        done = self._busy.pop(key, None)
        if done is not None:
            done.synchronize()
        return self._buffer(key).numpy()

    def upload(self, name, slot, a: np.ndarray) -> torch.Tensor:
        """``a``, the :meth:`host` view of buffer (``name``, ``slot``), on
        the device, for the compute stream."""
        self.moved += a.nbytes
        t = torch.from_numpy(a)
        if not self.pin:
            return t
        with torch.cuda.stream(self._up):
            d = t.to(self.dev, non_blocking=True)
        done = self._up.record_event()
        self._busy[self._key(name, slot, a.shape, a.dtype)] = done
        self._compute.wait_event(done)
        d.record_stream(self._compute)
        return d

    def download(self, name, slot, t: torch.Tensor):
        """Queue the copy of ``t`` into host buffer (``name``, ``slot``)
        after the compute queued so far.  Returns the buffer's numpy view
        and the event after which it holds ``t`` (None on the CPU, where
        the view is ``t`` itself).  The caller reads the view, and the next
        download into the buffer is queued, only after :meth:`wait` on that
        event."""
        self.moved += t.nbytes
        if not self.pin:
            return t.numpy(), None
        buf = self._buffer(self._key(name, slot, t.shape, t.dtype))
        self._down.wait_stream(self._compute)
        with torch.cuda.stream(self._down):
            buf.copy_(t, non_blocking=True)
        t.record_stream(self._down)
        return buf.numpy(), self._down.record_event()

    @staticmethod
    def wait(done):
        """Wait on the host for a :meth:`download`'s event."""
        if done is not None:
            done.synchronize()


def streamed_map_overlap(fn, x, depth: int, block_rows: int = 4096,
                         out_dtype=None, device=None):
    """Apply a local function to a host 2-D array (leading batch axes
    allowed) band by band along axis -2 with ``depth`` halo rows.

    ``fn`` takes and returns a tensor on ``device`` (default ``cuda``); it
    must be shift-invariant with receptive-field radius <= ``depth`` along
    axis -2 and treat out-of-domain rows as zero (``mode="constant"``).
    Every band it sees has the shape ``(..., block + 2 depth, W)``.  The
    result's rows are trimmed and written to a host output array.  One
    band is in flight (see the module docstring): band i's rows reach the
    output after band i+1 has been filled and queued.
    """
    x = np.asarray(x)
    stage = _Staging(resolve_device(device))
    n = x.shape[-2]
    block = min(block_rows, n)
    shape = x.shape[:-2] + (block + 2 * depth, x.shape[-1])
    out, prev = None, None
    for i, (s, e) in enumerate(_band_slices(n, block)):
        xb = stage.host("x", shape, x.dtype, i % 2)
        _fill_halo(xb, x, s, e, depth)
        yb = fn(stage.upload("x", i % 2, xb))
        rows, done = stage.download("y", i % 2,
                                    yb[..., depth:depth + (e - s), :])
        if out is None:
            out = np.zeros(rows.shape[:-2] + (n,) + rows.shape[-1:],
                           out_dtype or rows.dtype)
        if prev is not None:
            _drain(stage, prev, out)
        prev = (s, e, rows, done)
    if prev is not None:
        _drain(stage, prev, out)
    return out


def _drain(stage, item, out):
    """Band ``item``'s rows into ``out``, once its copy down is done."""
    s, e, rows, done = item
    stage.wait(done)
    out[..., s:e, :] = rows


def streamed_block_diag(ops, xs, device=None):
    """Apply ``ops[i]`` to host-resident block ``xs[i]``, one block in
    flight as in :func:`streamed_map_overlap` (the staging buffers are
    keyed by shape, so the blocks' shapes may differ).  Returns host
    blocks."""
    if len(ops) != len(xs):
        raise ValueError(f"{len(ops)} ops vs {len(xs)} blocks")
    stage = _Staging(resolve_device(device))
    out, prev = [], None
    for i, (op, xb) in enumerate(zip(ops, xs)):
        xb = np.asarray(xb)
        buf = stage.host("x", xb.shape, xb.dtype, i % 2)
        np.copyto(buf, xb)
        item = stage.download("y", i % 2,
                              op.apply(stage.upload("x", i % 2, buf)))
        if prev is not None:
            out.append(_copied(stage, *prev))
        prev = item
    if prev is not None:
        out.append(_copied(stage, *prev))
    return out


def _copied(stage, rows, done):
    """A copy of block ``rows``, once its copy down is done."""
    stage.wait(done)
    return np.array(rows)


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
                xpb, zpb = self._step(*(stage.upload(k, 0, a) for k, a in (
                    ("x", xb), ("z", zb), ("y", yb), ("mask", mask))))
                n = e - s
                x_out, _ = stage.download("x_out", 0, xpb[Hh:Hh + n])
                z_out, done = stage.download("z_out", 0, zpb[:, Hh:Hh + n])
                stage.wait(done)        # the copies down run in order
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
