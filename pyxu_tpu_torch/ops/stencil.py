r"""Separable 2-D correlation, the apply and adjoint of a 2-D separable
Stencil (counterpart of ``pyxu_tpu/ops/pallas_stencil.py``).

Function, per image of the trailing two axes::

    apply:    y[i, j] = sum_a sum_b k0[a] k1[b] x[m_H(i + a - c0), m_W(j + b - c1)]
    adjoint:  full correlation with the flipped taps, then the pad's fold-back

with ``m`` the boundary map of ``mode``: zero outside the image
(``constant``) or the numpy ``symmetric`` reflection.

* :func:`separable_correlate2d_plain` — the plain PyTorch version: per axis,
  pad then a weighted sum of shifted slices (:func:`fwd_axis`), or the full
  correlation then the fold-back (:func:`adj_axis`);
* :func:`separable_correlate2d` — the wrapper.  On a CUDA tensor it launches
  the hand-written kernel of ``csrc/stencil.cu`` (or raises); on a CPU
  tensor it runs the plain version.  ``separable_correlate2d.launches``
  counts kernel launches;
* :func:`separable_correlate2d_members` and its plain version
  :func:`separable_correlate2d_members_plain` — N correlations with one
  centre, tap counts and mode but a tap set each (:class:`MemberTaps`),
  image ``b`` of the batch taking member ``b % N``'s taps: the counterpart
  of the JAX package's ``jax.vmap`` over a family of Stencils' taps
  (``pyxu_tpu/operator/blocks.py``), one launch of the same kernel with
  the taps in device memory.  ``separable_correlate2d_members.launches``
  counts its launches.

The kernel takes float32 and float64, constant and symmetric modes, and at
most ``_MAX_TAPS`` taps per axis; :func:`kernel_takes` is the rule a
Stencil applies once, at construction.  :func:`launch_plan` mirrors the
kernel's launch geometry (row strips, column bands, fold edge tiles).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pyxu_tpu_torch.operator.linop.pad import pad_axis, pad_axis_adjoint
from pyxu_tpu_torch.ops._build import compile_and_load
from pyxu_tpu_torch.ops._guard import refuse_autodiff

__all__ = [
    "SepTaps",
    "MemberTaps",
    "kernel_takes",
    "fwd_axis",
    "adj_axis",
    "separable_correlate2d_plain",
    "separable_correlate2d",
    "separable_correlate2d_members_plain",
    "separable_correlate2d_members",
    "launch_plan",
    "kernel_plan",
    "edge_rects",
    "build",
]

_MAX_TAPS = 32                       # ST_MAXL of csrc/stencil.cu
_FAST_TAPS = 9                       # ST_FAST_L: the unrolled path
# ST_CPT, ST_WARPS, ST_NBUF, ST_SR, ST_SR_MIN, ST_FILL, ST_BLOCKS
_GEOM = {"cpt": 4, "warps": 8, "nbuf": 4, "sr": 32, "sr_min": 4,
         "fill": 1024, "blocks": 132}
_EDGE_TILE = (32, 64)                # ST_TR, ST_TC
_MAX_SMEM = 232448                   # ST_SMEM_MAX
_MODES = ("constant", "symmetric")
_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class SepTaps:
    """Static data of one 2-D separable correlation: the taps (host floats)
    and centre of each axis, and the boundary mode."""

    k0: tuple
    c0: int
    k1: tuple
    c1: int
    mode: str = "constant"

    @property
    def halo(self) -> tuple:
        """Window halo per side, max(c, L-1-c), along rows and columns."""
        return (max(self.c0, len(self.k0) - 1 - self.c0),
                max(self.c1, len(self.k1) - 1 - self.c1))


class MemberTaps:
    """N tap sets of 2-D separable correlations that share their centres,
    tap counts and boundary mode: ``k0`` ``(N, L0)``, ``k1`` ``(N, L1)``
    (host float64).  The kernel reads them from device memory, cached per
    device, dtype and direction."""

    def __init__(self, taps):
        taps = list(taps)
        p = taps[0]
        if any((q.c0, q.c1, len(q.k0), len(q.k1), q.mode)
               != (p.c0, p.c1, len(p.k0), len(p.k1), p.mode) for q in taps):
            raise ValueError("member taps differ in centre, count or mode")
        self.k0 = np.array([q.k0 for q in taps], dtype=np.float64)
        self.k1 = np.array([q.k1 for q in taps], dtype=np.float64)
        self.c0, self.c1, self.mode = p.c0, p.c1, p.mode
        self.taps = tuple(taps)
        self._dev = {}

    @property
    def n(self) -> int:
        return len(self.taps)

    def device_taps(self, device, dtype, adjoint: bool) -> tuple:
        """``(k0, k1)`` of the kernel's correlation on ``device`` in
        ``dtype``: the adjoint's taps flipped."""
        key = (torch.device(device), dtype, adjoint)
        hit = self._dev.get(key)
        if hit is None:
            k0, k1 = ((self.k0[:, ::-1], self.k1[:, ::-1]) if adjoint
                      else (self.k0, self.k1))
            hit = self._dev[key] = tuple(
                torch.tensor(np.ascontiguousarray(k), dtype=dtype,
                             device=device) for k in (k0, k1))
        return hit


def kernel_takes(p: SepTaps) -> bool:
    """Whether the kernel computes this correlation: a mode it takes and at
    most ``_MAX_TAPS`` taps per axis (so the halo fits its tile)."""
    return (p.mode in _MODES and 1 <= len(p.k0) <= _MAX_TAPS
            and 1 <= len(p.k1) <= _MAX_TAPS)


# ------------------------------------------------------------ plain version --

def _tap(k, t):
    """Tap ``t`` of ``k``: a Python float, or for member taps (a tensor
    ``(L, N)``) a tensor that broadcasts over the member axis, the third
    from last."""
    if isinstance(k, torch.Tensor):
        return k[t].reshape(-1, 1, 1)
    return float(k[t])


def fwd_axis(x, k, c, ax, mode):
    """Correlation along axis ``ax``: pad(mode) then a weighted sum of
    shifted slices."""
    L, n = len(k), x.shape[ax]
    xp = pad_axis(x, ax, c, L - 1 - c, mode)
    out = None
    for t in range(L):
        term = _tap(k, t) * xp.narrow(ax, t, n)
        out = term if out is None else out + term
    return out


def adj_axis(r, k, c, ax, mode):
    """Adjoint of :func:`fwd_axis`: full correlation with the flipped taps,
    then the pad's fold-back."""
    L, n = len(k), r.shape[ax]
    rp = pad_axis(r, ax, L - 1, L - 1, "constant")
    out = None
    for t in range(L):
        term = _tap(k, L - 1 - t) * rp.narrow(ax, t, n + L - 1)
        out = term if out is None else out + term
    return pad_axis_adjoint(out, ax, c, L - 1 - c, n, mode)


def separable_correlate2d_plain(x, p: SepTaps, adjoint: bool = False):
    """The function of the kernel over the trailing two axes of ``x``, in
    its dtype: rows first, then columns."""
    a0, a1 = x.ndim - 2, x.ndim - 1
    if adjoint:
        return adj_axis(adj_axis(x, p.k0, p.c0, a0, p.mode), p.k1, p.c1, a1,
                        p.mode)
    return fwd_axis(fwd_axis(x, p.k0, p.c0, a0, p.mode), p.k1, p.c1, a1,
                    p.mode)


def _member_input(x, mt: MemberTaps, shared_input: bool):
    """``x`` with the member axis (third from last): a shared input
    ``(..., H, W)`` broadcast to ``(..., N, H, W)``."""
    if shared_input:
        return x.unsqueeze(-3).expand(x.shape[:-2] + (mt.n,) + x.shape[-2:])
    return x


def separable_correlate2d_members_plain(x, mt: MemberTaps,
                                        adjoint: bool = False,
                                        shared_input: bool = False):
    """Member ``i``'s correlation of image ``(..., i, :, :)`` of ``x``
    ``(..., N, H, W)``, in its dtype; ``shared_input``: ``x`` is ``(...,
    H, W)``, each member's input, and the result ``(..., N, H, W)``."""
    x = _member_input(x, mt, shared_input)
    k0, k1 = (torch.as_tensor(k.T, dtype=x.dtype, device=x.device)
              for k in (mt.k0, mt.k1))
    a0, a1 = x.ndim - 2, x.ndim - 1
    if adjoint:
        return adj_axis(adj_axis(x, k0, mt.c0, a0, mt.mode), k1, mt.c1, a1,
                        mt.mode)
    return fwd_axis(fwd_axis(x, k0, mt.c0, a0, mt.mode), k1, mt.c1, a1,
                    mt.mode)


# ---------------------------------------------------------- launch geometry --

def _cdiv(a, b):
    return -(-a // b)


def edge_rects(plan: dict) -> list:
    """The fold's frame as four rectangles ``(r0, r1, q0, q1)`` (top,
    bottom, left, right; ``st_rect``), each cut into edge tiles of
    ``_EDGE_TILE``; empty ones included."""
    H, W = plan["shape"]
    fa, fb, fa1, fb1 = plan["frame"]
    return [(0, fa, 0, W), (fb, H, 0, W), (fa, fb, 0, fa1), (fa, fb, fb1, W)]


def launch_plan(shape, p: SepTaps, adjoint: bool = False,
                dtype=torch.float32) -> dict:
    """The launch of ``csrc/stencil.cu`` (``st_plan``) for images of
    ``shape`` ``(..., H, W)``: one warp per column band of ``band`` columns
    and row strip of ``sr`` rows, ``warps`` a block; in symmetric adjoint
    mode (the fold) the streaming warps store only the outputs inside
    ``frame`` (rows ``[fa, fb)`` x columns ``[fa1, fb1)``) and
    ``edge_blocks`` more blocks compute the rest.  ``smem_bytes`` is a
    block's dynamic shared memory, ``vec`` the 16-byte path (for 16-byte
    aligned pointers), ``fast`` the unrolled 9+9-tap path."""
    H, W = int(shape[-2]), int(shape[-1])
    B = int(np.prod(shape[:-2], dtype=np.int64))
    elem = torch.empty((), dtype=dtype).element_size()
    V = 16 // elem
    L0, L1 = len(p.k0), len(p.k1)
    h0, h1 = p.halo
    fold = p.mode == "symmetric" and adjoint
    fast = L0 == L1 == _FAST_TAPS
    band = 32 * _GEOM["cpt"]
    bands = _cdiv(W, band)
    sr = _GEOM["sr"]
    while sr > _GEOM["sr_min"] and B * bands * _cdiv(H, sr) < _GEOM["fill"]:
        sr //= 2
    strips = _cdiv(H, sr)
    H1 = _cdiv(h1, V) * V
    rw = band + 2 * H1 + V
    warp_elems = _GEOM["nbuf"] * rw + (0 if fast else L0 * band)
    if fold:
        fa, fa1 = min(h0, H), min(h1, W)
        frame = (fa, max(H - h0, fa), fa1, max(W - h1, fa1))
    else:
        frame = (0, H, 0, W)
    plan = dict(shape=(H, W), batch=B, band=band, bands=bands, sr=sr,
                strips=strips, frame=frame, ring_row=rw, vec=W % V == 0,
                fast=fast)
    tr, tc = _EDGE_TILE
    n_edge = 0
    if fold:
        for r0, r1, q0, q1 in edge_rects(plan):
            if r1 > r0 and q1 > q0:
                n_edge += _cdiv(r1 - r0, tr) * _cdiv(q1 - q0, tc)
    edge_smem = ((tr + 2 * h0) * (tc + 2 * h1) + tr * (tc + 2 * h1)) * elem \
        if n_edge else 0
    warps = _GEOM["warps"]
    while True:
        smem = max(warps * warp_elems * elem, edge_smem)
        n_stream = _cdiv(bands * strips, warps)
        if warps == 2 or (smem <= _MAX_SMEM
                          and B * n_stream >= _GEOM["blocks"]):
            break
        warps //= 2
    plan.update(warps=warps, stream_blocks=n_stream, edge_blocks=n_edge,
                smem_bytes=smem)
    return plan


# ------------------------------------------------------------- CUDA kernel --

@functools.cache
def _library(defines: tuple = ()):
    """Compile ``csrc/stencil.cu`` (once per source hash and ``defines``)
    and load it.  The tests' ``("ST_COUNT_STRAY_READS",)`` build also counts
    window reads outside the image (``stencil_stray_reads``)."""
    lib, log = compile_and_load("stencil.cu", defines)
    taps = ctypes.POINTER(ctypes.c_double)
    lib.stencil_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        taps, ctypes.c_int, ctypes.c_int, taps, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.stencil_launch.restype = ctypes.c_int
    lib.stencil_launch_members.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.stencil_launch_members.restype = ctypes.c_int
    lib.stencil_plan.argtypes = [ctypes.c_int] * 10 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.stencil_plan.restype = ctypes.c_int
    lib.stencil_error_string.argtypes = [ctypes.c_int]
    lib.stencil_error_string.restype = ctypes.c_char_p
    if "ST_COUNT_STRAY_READS" in defines:
        lib.stencil_stray_reads.restype = ctypes.c_longlong
    return lib, log


def build() -> str:
    """Build and load the kernel; returns the compiler's output (empty when
    the library was already built)."""
    return _library()[1]


def _check(x, p: SepTaps):
    refuse_autodiff("separable_correlate2d", x)
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype}: the kernel takes float32 or "
                         "float64")
    if x.ndim < 2 or x.shape[-2] < 1 or x.shape[-1] < 1:
        raise ValueError(f"shape {tuple(x.shape)}: want (..., H, W)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not kernel_takes(p):
        raise ValueError(f"the kernel takes modes {_MODES} and at most "
                         f"{_MAX_TAPS} taps per axis")
    if max(p.halo[0] - x.shape[-2], p.halo[1] - x.shape[-1]) > 0:
        raise ValueError("pad width exceeds the axis length")
    if x.numel() // (x.shape[-2] * x.shape[-1]) > 65535:
        raise ValueError("at most 65535 images per launch")


def separable_correlate2d(x, p: SepTaps, adjoint: bool = False):
    """Apply (or adjoint) of the separable correlation over the trailing two
    axes: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return separable_correlate2d_plain(x, p, adjoint)
    _check(x, p)
    separable_correlate2d.launches += 1
    return _launch(_library()[0], x, p, adjoint)


def separable_correlate2d_members(x, mt: MemberTaps, adjoint: bool = False,
                                  shared_input: bool = False):
    """:func:`separable_correlate2d_members_plain`'s function: one launch of
    the kernel with per-member taps for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return separable_correlate2d_members_plain(x, mt, adjoint,
                                                   shared_input)
    p = mt.taps[0]
    _check(x, p)
    if not shared_input and (x.ndim < 3 or x.shape[-3] != mt.n):
        raise ValueError(f"shape {tuple(x.shape)}: want (..., {mt.n}, H, W)")
    n_out = x.numel() // (x.shape[-2] * x.shape[-1]) * (
        mt.n if shared_input else 1)
    if n_out > 65535:
        raise ValueError("at most 65535 images per launch")
    separable_correlate2d_members.launches += 1
    return _launch_members(_library()[0], x, mt, adjoint, shared_input)


def _launch_members(lib, x, mt: MemberTaps, adjoint: bool,
                    shared_input: bool):
    """One launch of ``lib``'s kernel with per-member taps on the checked
    CUDA tensor ``x``."""
    _, c0, _, c1 = _kernel_taps(mt.taps[0], adjoint)
    k0, k1 = mt.device_taps(x.device, x.dtype, adjoint)
    sym = int(mt.mode == "symmetric")
    H, W = x.shape[-2:]
    y = torch.empty(_member_input(x, mt, shared_input).shape,
                    dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stencil_launch_members(
            x.data_ptr(), y.data_ptr(), y.numel() // (H * W), H, W,
            int(x.dtype == torch.float64), k0.data_ptr(), k0.shape[1], c0,
            k1.data_ptr(), k1.shape[1], c1, mt.n,
            mt.n if shared_input else 1, sym * int(not adjoint),
            sym * int(adjoint), stream)
    if err != 0:
        raise RuntimeError(f"stencil_launch_members: CUDA error {err} "
                           f"({lib.stencil_error_string(err).decode()})")
    return y


def _kernel_taps(p: SepTaps, adjoint: bool):
    """(k0, c0, k1, c1) of the kernel's correlation: the adjoint's are the
    flipped taps and mirrored centres."""
    if adjoint:
        return (p.k0[::-1], len(p.k0) - 1 - p.c0,
                p.k1[::-1], len(p.k1) - 1 - p.c1)
    return p.k0, p.c0, p.k1, p.c1


def kernel_plan(lib, shape, p: SepTaps, adjoint: bool = False,
                dtype=torch.float32) -> dict:
    """``lib``'s own launch geometry (``stencil_plan``) for the call
    :func:`launch_plan` mirrors, by the same keys."""
    k0, c0, k1, c1 = _kernel_taps(p, adjoint)
    sym = int(p.mode == "symmetric")
    out = (ctypes.c_longlong * 10)()
    B = int(np.prod(shape[:-2], dtype=np.int64))
    err = lib.stencil_plan(B, shape[-2], shape[-1],
                           int(dtype == torch.float64), len(k0), c0, len(k1),
                           c1, sym * int(not adjoint), sym * int(adjoint),
                           out)
    if err != 0:
        raise ValueError(f"stencil_plan: error {err}")
    keys = ("bands", "strips", "sr", "warps", "stream_blocks", "edge_blocks",
            "smem_bytes", "ring_row", "vec", "fast")
    return {k: (bool(v) if k in ("vec", "fast") else int(v))
            for k, v in zip(keys, out)}


def _launch(lib, x, p: SepTaps, adjoint: bool):
    """One launch of ``lib``'s kernel on the checked CUDA tensor ``x``."""
    # flipped taps, mirrored centres; fold in symmetric mode
    k0, c0, k1, c1 = _kernel_taps(p, adjoint)
    sym = int(p.mode == "symmetric")
    H, W = x.shape[-2:]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stencil_launch(
            x.data_ptr(), y.data_ptr(), x.numel() // (H * W), H, W,
            int(x.dtype == torch.float64),
            (ctypes.c_double * len(k0))(*k0), len(k0), c0,
            (ctypes.c_double * len(k1))(*k1), len(k1), c1,
            sym * int(not adjoint), sym * int(adjoint), stream)
    if err != 0:
        raise RuntimeError(f"stencil_launch: CUDA error {err} "
                           f"({lib.stencil_error_string(err).decode()})")
    return y


separable_correlate2d.launches = 0
separable_correlate2d_members.launches = 0
