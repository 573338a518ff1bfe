r"""2-D NUFFT spread and interp (counterpart of the 2-D kernels of
``pyxu_tpu/ops/pallas_nufft.py``: ``slab_spread``/``slab_interp``,
``strip_spread2``/``strip_interp2``, ``ragged_spread2``/``ragged_interp2``).

Function, per batch element, for a :class:`Plan2` of M points with w taps
per axis on the periodic fine grid ``(n1, n2)``::

    spread:  g[(i0_1 + t1) % n1, (i0_2 + t2) % n2] += c_p w1(t1) w2(t2)
    interp:  v_p = sum_{t1, t2} g[...] w1(t1) w2(t2)

with the ES weights ``w(t) = phi(z(t))``, ``phi(z) = exp(beta (sqrt(1 - z^2)
- 1))`` on |z| <= 1 and ``z(t) = (t - off) * 2 / w``.  Values are complex as ``(..., 2)`` real
pairs: strengths ``(B, M, 2)`` and grids ``(B, n1, n2, 2)``, points in
their original order.

* :func:`plan2` — the plan, built once on the points' device in float64:
  left taps and offsets per axis, the sort by 32x32 bin, and the
  subproblems (bins cut into runs of at most ``MAX_SUB`` points).  Sorting
  and counting use library calls (``argsort``, ``bincount``, ``cumsum``);
* :func:`nufft_spread2_plain` / :func:`nufft_interp2_plain` — the plain
  PyTorch versions: ``index_add_`` of the w^2 tap products, and a gather
  and sum;
* :func:`nufft_spread2` / :func:`nufft_interp2` — the wrappers.  On a CUDA
  tensor they launch the hand-written kernels of ``csrc/nufft.cu`` (or
  raise); on a CPU tensor they run the plain versions.  ``.launches``
  counts kernel launches.

The kernels take float32 and float64, 2 to 16 taps and any grid size.  An
empty point set (M = 0) launches nothing: spread gives zeros, interp an
empty result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pyxu_tpu_torch.ops._build import compile_and_load

__all__ = [
    "Plan2",
    "plan2",
    "es_weights",
    "nufft_spread2_plain",
    "nufft_interp2_plain",
    "nufft_spread2",
    "nufft_interp2",
    "build",
]

BIN = 32            # NU_BIN of csrc/nufft.cu
MAX_SUB = 1024      # most points of one subproblem (cuFINUFFT's default)
MAX_W = 16          # NU_MAXW
_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan2:
    """Geometry of M points on the periodic fine grid ``nf = (n1, n2)``.

    ``perm`` (M,) int32: the original index of each sorted point.  ``i0``
    (2, M) int32: each sorted point's left tap per axis, shifted by whole
    periods so that ``i0 + w // 2`` lies in ``[0, n)``.  ``off`` (2, M) in
    ``dtype``: ``x / h - i0`` in ``(w/2 - 1, w/2]``, from float64.  ``sub``
    (n_sub, 3) int32: per subproblem the bin ``b1 * nbins[1] + b2``, its
    first sorted point and its point count.
    """

    nf: tuple
    w: int
    beta: float
    M: int
    nbins: tuple
    perm: torch.Tensor
    i0: torch.Tensor
    off: torch.Tensor
    sub: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.off.dtype

    @property
    def device(self) -> torch.device:
        return self.off.device


def plan2(x: torch.Tensor, nf, w: int, beta: float,
          dtype: torch.dtype) -> Plan2:
    """Plan of the points ``x`` ((M, 2) float64, folded into [0, 2 pi)) on
    the fine grid ``nf`` with ``w`` taps, on ``x``'s device.  Offsets are
    computed in float64 and stored in ``dtype``: a float32 ``x / h`` at
    n = 2048 would carry ~1e-4 of a cell of rounding."""
    if x.dtype != torch.float64 or x.ndim != 2 or x.shape[1] != 2:
        raise ValueError("x must be an (M, 2) float64 tensor")
    if not 2 <= w <= MAX_W:
        raise ValueError(f"w = {w}: the kernels take 2 to {MAX_W} taps")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: want float32 or float64")
    dev, M = x.device, x.shape[0]
    nf = tuple(int(n) for n in nf)
    hw = w // 2
    cols_i0, cols_off, bins = [], [], []
    for ax, n in enumerate(nf):
        xs = x[:, ax] / (2 * math.pi / n)
        i0 = torch.ceil(xs - w / 2.0)
        cols_off.append(xs - i0)
        base = torch.remainder(i0.to(torch.int64) + hw, n)   # in [0, n)
        cols_i0.append(base - hw)
        bins.append(base // BIN)
    nbins = tuple(-(-n // BIN) for n in nf)
    binid = bins[0] * nbins[1] + bins[1]
    perm = torch.argsort(binid, stable=True)
    counts = torch.bincount(binid, minlength=nbins[0] * nbins[1])
    starts = torch.cumsum(counts, 0) - counts
    nsub_bin = (counts + MAX_SUB - 1) // MAX_SUB
    n_sub = int(nsub_bin.sum())                 # the plan's one host read
    sub_bin = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), nsub_bin, output_size=n_sub)
    k = (torch.arange(n_sub, device=dev)
         - (torch.cumsum(nsub_bin, 0) - nsub_bin)[sub_bin]) * MAX_SUB
    sub = torch.stack([sub_bin, starts[sub_bin] + k,
                       torch.clamp(counts[sub_bin] - k, max=MAX_SUB)], dim=1)
    return Plan2(
        nf=nf, w=int(w), beta=float(beta), M=M, nbins=nbins,
        perm=perm.to(torch.int32),
        i0=torch.stack(cols_i0)[:, perm].to(torch.int32).contiguous(),
        off=torch.stack(cols_off)[:, perm].to(dtype).contiguous(),
        sub=sub.to(torch.int32).contiguous())


# ------------------------------------------------------------ plain version --

def es_weights(off: torch.Tensor, w: int, beta: float) -> torch.Tensor:
    """ES weights ``(..., w)`` of offsets ``(...)``, in their dtype."""
    t = torch.arange(w, dtype=off.dtype, device=off.device)
    z = (t - off[..., None]) * (2.0 / w)
    q = torch.clamp(1.0 - z * z, min=0.0)
    return torch.where(z.abs() <= 1.0,
                       torch.exp(beta * (torch.sqrt(q) - 1.0)), 0.0)


def _taps(plan: Plan2):
    """Flat grid index and weight (M, w, w) of each sorted point's taps."""
    n1, n2 = plan.nf
    t = torch.arange(plan.w, device=plan.device)
    r = (plan.i0[0].long()[:, None] + t) % n1
    s = (plan.i0[1].long()[:, None] + t) % n2
    w1 = es_weights(plan.off[0], plan.w, plan.beta)
    w2 = es_weights(plan.off[1], plan.w, plan.beta)
    return (r[:, :, None] * n2 + s[:, None, :],
            w1[:, :, None] * w2[:, None, :])


def nufft_spread2_plain(c: torch.Tensor, plan: Plan2) -> torch.Tensor:
    """Strengths ``(B, M, 2)`` -> grid ``(B, n1, n2, 2)``, by ``index_add_``
    of the w^2 tap products."""
    B, (n1, n2) = c.shape[0], plan.nf
    idx, wt = _taps(plan)
    cs = c[:, plan.perm.long()]
    vals = cs[:, :, None, None, :] * wt[None, :, :, :, None]
    g = torch.zeros((B, n1 * n2, 2), dtype=c.dtype, device=c.device)
    g.index_add_(1, idx.reshape(-1), vals.reshape(B, -1, 2))
    return g.reshape(B, n1, n2, 2)


def nufft_interp2_plain(g: torch.Tensor, plan: Plan2) -> torch.Tensor:
    """Grid ``(B, n1, n2, 2)`` -> values ``(B, M, 2)``, by a gather of the
    w^2 taps and a weighted sum."""
    B, (n1, n2) = g.shape[0], plan.nf
    idx, wt = _taps(plan)
    vals = g.reshape(B, n1 * n2, 2)[:, idx.reshape(-1)]
    vals = vals.reshape(B, plan.M, plan.w, plan.w, 2)
    v = torch.sum(vals * wt[None, :, :, :, None], dim=(2, 3))
    out = torch.empty_like(v)
    out[:, plan.perm.long()] = v
    return out


# ------------------------------------------------------------- CUDA kernel --

@functools.cache
def _library():
    """Compile ``csrc/nufft.cu`` (once per source hash) and load it."""
    lib, log = compile_and_load("nufft.cu")
    for fn in (lib.nufft_spread2_launch, lib.nufft_interp2_launch):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nufft_error_string.argtypes = [ctypes.c_int]
    lib.nufft_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build and load the kernels; returns the compiler's output (empty
    when the library was already built)."""
    return _library()[1]


def _check(a: torch.Tensor, plan: Plan2, core: tuple):
    if not a.is_cuda:
        raise ValueError(f"input must lie on a CUDA device, not {a.device}")
    if a.dtype != plan.dtype:
        raise ValueError(f"dtype {a.dtype} does not match the plan's "
                         f"{plan.dtype}")
    if a.device != plan.device:
        raise ValueError(f"input on {a.device}, plan on {plan.device}")
    if a.ndim != 1 + len(core) or tuple(a.shape[1:]) != core:
        raise ValueError(f"shape {tuple(a.shape)}: want (B, *{core})")
    if not a.is_contiguous():
        raise ValueError("input must be contiguous")
    if not 1 <= a.shape[0] <= 65535:
        raise ValueError("1 to 65535 batch elements per launch")


def _launch(fn, src: torch.Tensor, dst: torch.Tensor, plan: Plan2):
    lib = _library()[0]
    n1, n2 = plan.nf
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(lib, fn)(
            src.data_ptr(), dst.data_ptr(), plan.perm.data_ptr(),
            plan.i0.data_ptr(), plan.off.data_ptr(), plan.sub.data_ptr(),
            plan.sub.shape[0], src.shape[0], plan.M, n1, n2, plan.nbins[1],
            plan.w, plan.beta, int(src.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.nufft_error_string(err).decode()})")


def nufft_spread2(c: torch.Tensor, plan: Plan2) -> torch.Tensor:
    """Spread of ``c`` ``(B, M, 2)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if c.device.type == "cpu":
        return nufft_spread2_plain(c, plan)
    _check(c, plan, (plan.M, 2))
    g = torch.zeros((c.shape[0],) + plan.nf + (2,), dtype=c.dtype,
                    device=c.device)
    if plan.M == 0:
        return g
    nufft_spread2.launches += 1
    _launch("nufft_spread2_launch", c, g, plan)
    return g


def nufft_interp2(g: torch.Tensor, plan: Plan2) -> torch.Tensor:
    """Interp of the grid ``g`` ``(B, n1, n2, 2)`` at the plan's points:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if g.device.type == "cpu":
        return nufft_interp2_plain(g, plan)
    _check(g, plan, plan.nf + (2,))
    out = torch.empty((g.shape[0], plan.M, 2), dtype=g.dtype,
                      device=g.device)
    if plan.M == 0:
        return out
    nufft_interp2.launches += 1
    _launch("nufft_interp2_launch", g, out, plan)
    return out


nufft_spread2.launches = 0
nufft_interp2.launches = 0
