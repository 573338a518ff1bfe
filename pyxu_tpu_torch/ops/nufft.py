r"""NUFFT spread and interp in d = 2 and d = 3 (counterpart of the kernels
of ``pyxu_tpu/ops/pallas_nufft.py``: in 2-D ``slab_spread``/``slab_interp``,
``strip_spread2``/``strip_interp2``, ``ragged_spread2``/``ragged_interp2``;
in 3-D ``slab_spread3``/``slab_interp3``, ``pencil_spread3``/
``pencil_interp3``, ``strip_spread3``/``strip_interp3``,
``ragged_spread3``/``ragged_interp3`` and ``ragged_pencil_spread3``/
``ragged_pencil_interp3``).

Function, per batch element, for a :class:`Plan` of M points with w taps
per axis on the periodic fine grid ``nf = (n1, ..., nd)``::

    spread:  g[(i0_1 + t1) % n1, ..., (i0_d + td) % nd] += c_p w1(t1)...wd(td)
    interp:  v_p = sum_{t1, ..., td} g[...] w1(t1) ... wd(td)

with the ES weights ``w(t) = phi(z(t))``, ``phi(z) = exp(beta (sqrt(1 - z^2)
- 1))`` on |z| <= 1 and ``z(t) = (t - off) * 2 / w``.  Values are complex as ``(..., 2)`` real
pairs: strengths ``(B, M, 2)`` and grids ``(B, *nf, 2)``, points in
their original order.

* :func:`plan2` / :func:`plan3` — the plan, built once on the points'
  device in float64: left taps and offsets per axis, the stable sort by
  bin (32x32 in 2-D, :func:`bin3` in 3-D), and the subproblems (bins cut
  into runs of at most ``MAX_SUB`` points).  Sorting and counting use
  library calls (``argsort``, ``bincount``, ``cumsum``);
* :func:`nufft_spread2_plain` / :func:`nufft_interp2_plain` and the ``3``
  forms — the plain PyTorch versions: ``index_add_`` of the w^d tap
  products, and a gather and sum, over chunks of points (at most
  ``TAPS_PER_CHUNK`` taps a chunk, which bounds their memory).  They run
  in the plan's dtype; a float64 reference of a float32 plan's sums is
  ``plain(a.double(), plan.astype(torch.float64))``;
* :func:`nufft_spread2` / :func:`nufft_interp2` and the ``3`` forms — the
  wrappers.  On a CUDA tensor they launch the hand-written kernels of
  ``csrc/nufft.cu`` (or raise); on a CPU tensor they run the plain
  versions.  ``.launches`` counts kernel launches.

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
    "Plan",
    "plan2",
    "plan3",
    "bin3",
    "es_weights",
    "nufft_spread2_plain",
    "nufft_interp2_plain",
    "nufft_spread3_plain",
    "nufft_interp3_plain",
    "nufft_spread2",
    "nufft_interp2",
    "nufft_spread3",
    "nufft_interp3",
    "build",
]

BIN = 32            # NU_BIN of csrc/nufft.cu: the 2-D bin side
MAX_SUB = 1024      # most points of one subproblem (cuFINUFFT's default)
MAX_W = 16          # NU_MAXW
SMEM_MAX = 232_448  # shared memory one block may opt in to (227 KB)
TAPS_PER_CHUNK = 1 << 24    # plain versions: tap products per chunk
_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Geometry of M points on the periodic fine grid ``nf`` (d = 2 or 3
    axes).

    ``bins``: the bin's side per axis; ``nbins``: bins per axis.  ``perm``
    (M,) int32: the original index of each sorted point.  ``i0`` (d, M)
    int32: each sorted point's left tap per axis, shifted by whole periods
    so that ``i0 + w // 2`` lies in ``[0, n)``.  ``off`` (d, M) in
    ``dtype``: ``x / h - i0`` in ``(w/2 - 1, w/2]``, from float64.  ``sub``
    (n_sub, 3) int32: per subproblem the row-major bin index, its first
    sorted point and its point count.
    """

    nf: tuple
    w: int
    beta: float
    M: int
    bins: tuple
    nbins: tuple
    perm: torch.Tensor
    i0: torch.Tensor
    off: torch.Tensor
    sub: torch.Tensor

    @property
    def d(self) -> int:
        return len(self.nf)

    @property
    def dtype(self) -> torch.dtype:
        return self.off.dtype

    @property
    def device(self) -> torch.device:
        return self.off.device

    def astype(self, dtype: torch.dtype) -> "Plan":
        """This plan with its offsets in ``dtype``: the same points and
        bins.  A float32 running sum of the thousands of tap products that
        meet in one cell (a radial set's centre) drifts by up to ~3e-5 of
        the cell's value, so a float32 kernel is checked against the plain
        version run on this plan in float64."""
        return dataclasses.replace(self, off=self.off.to(dtype))


def bin3(w: int, dtype: torch.dtype) -> tuple:
    """The 3-D bin side per axis for ``w`` taps in ``dtype``.

    A block holds the bin's subgrid, the bin plus a w - 1 halo per axis,
    in shared memory: ``(b1 + w - 1)(b2 + w - 1)(b3 + w - 1)`` complex
    cells, 8 B each in float32 and 16 B in float64.  The spread adds every
    subgrid cell into the grid with global atomics, so the halo's share of
    the subgrid sets that pass's cost: the larger the bin, the smaller the
    share.  Rule: the first of 16x16x16, 16x16x8 and 8x8x8 whose subgrid
    fits half of the 227 KB a block may opt in to (two blocks an SM),
    else 8x8x8, whose subgrid needs at most 23^3 x 16 B = 194,672 B
    (w = 16, float64).  At w = 7 in float32, 16^3 bins (85,184 B) spread
    2^21 points onto a 256^3 grid faster than cuFINUFFT's 3-D default
    16x16x2 or than 8x8x8 on an H100 (``bench_nufft3_bins.py``; times in
    PERF.md).
    """
    cell = 8 if dtype == torch.float32 else 16
    for bins in ((16, 16, 16), (16, 16, 8)):
        if math.prod(b + w - 1 for b in bins) * cell <= SMEM_MAX // 2:
            return bins
    return (8, 8, 8)


def _plan(x: torch.Tensor, nf, w: int, beta: float, dtype: torch.dtype,
          bins: tuple) -> Plan:
    d = len(bins)
    if x.dtype != torch.float64 or x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"x must be an (M, {d}) float64 tensor")
    if len(nf) != d:
        raise ValueError(f"nf = {tuple(nf)}: want {d} grid sides")
    if not 2 <= w <= MAX_W:
        raise ValueError(f"w = {w}: the kernels take 2 to {MAX_W} taps")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: want float32 or float64")
    dev, M = x.device, x.shape[0]
    nf = tuple(int(n) for n in nf)
    hw = w // 2
    cols_i0, cols_off = [], []
    binid = torch.zeros(M, dtype=torch.int64, device=dev)
    nbins = tuple(-(-n // b) for n, b in zip(nf, bins))
    for ax, (n, b, nb) in enumerate(zip(nf, bins, nbins)):
        xs = x[:, ax] / (2 * math.pi / n)
        i0 = torch.ceil(xs - w / 2.0)
        cols_off.append(xs - i0)
        base = torch.remainder(i0.to(torch.int64) + hw, n)   # in [0, n)
        cols_i0.append(base - hw)
        binid = binid * nb + base // b
    perm = torch.argsort(binid, stable=True)
    counts = torch.bincount(binid, minlength=math.prod(nbins))
    starts = torch.cumsum(counts, 0) - counts
    nsub_bin = (counts + MAX_SUB - 1) // MAX_SUB
    n_sub = int(nsub_bin.sum())                 # the plan's one host read
    sub_bin = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), nsub_bin, output_size=n_sub)
    k = (torch.arange(n_sub, device=dev)
         - (torch.cumsum(nsub_bin, 0) - nsub_bin)[sub_bin]) * MAX_SUB
    sub = torch.stack([sub_bin, starts[sub_bin] + k,
                       torch.clamp(counts[sub_bin] - k, max=MAX_SUB)], dim=1)
    return Plan(
        nf=nf, w=int(w), beta=float(beta), M=M, bins=tuple(bins),
        nbins=nbins, perm=perm.to(torch.int32),
        i0=torch.stack(cols_i0)[:, perm].to(torch.int32).contiguous(),
        off=torch.stack(cols_off)[:, perm].to(dtype).contiguous(),
        sub=sub.to(torch.int32).contiguous())


def plan2(x: torch.Tensor, nf, w: int, beta: float,
          dtype: torch.dtype) -> Plan:
    """Plan of the points ``x`` ((M, 2) float64, folded into [0, 2 pi)) on
    the fine grid ``nf`` with ``w`` taps, on ``x``'s device, in 32x32 bins.
    Offsets are computed in float64 and stored in ``dtype``: a float32
    ``x / h`` at n = 2048 would carry ~1e-4 of a cell of rounding."""
    return _plan(x, nf, w, beta, dtype, (BIN, BIN))


def plan3(x: torch.Tensor, nf, w: int, beta: float,
          dtype: torch.dtype) -> Plan:
    """Plan of the points ``x`` ((M, 3) float64, folded into [0, 2 pi)) on
    the fine grid ``nf``, as :func:`plan2`, in bins of :func:`bin3`."""
    return _plan(x, nf, w, beta, dtype, bin3(w, dtype))


# ------------------------------------------------------------ plain version --

def es_weights(off: torch.Tensor, w: int, beta: float) -> torch.Tensor:
    """ES weights ``(..., w)`` of offsets ``(...)``, in their dtype."""
    t = torch.arange(w, dtype=off.dtype, device=off.device)
    z = (t - off[..., None]) * (2.0 / w)
    q = torch.clamp(1.0 - z * z, min=0.0)
    return torch.where(z.abs() <= 1.0,
                       torch.exp(beta * (torch.sqrt(q) - 1.0)), 0.0)


def _chunks(plan: Plan):
    """Runs ``(lo, hi)`` of sorted points of at most ``TAPS_PER_CHUNK``
    taps each."""
    step = max(1, TAPS_PER_CHUNK // plan.w ** plan.d)
    return [(lo, min(lo + step, plan.M)) for lo in range(0, plan.M, step)]


def _taps(plan: Plan, lo: int, hi: int):
    """Flat grid index and weight ``(m, w, ..., w)`` of the taps of the
    sorted points ``lo:hi``."""
    t = torch.arange(plan.w, device=plan.device)
    idx = wt = None
    for ax, n in enumerate(plan.nf):
        r = (plan.i0[ax, lo:hi].long()[:, None] + t) % n
        wa = es_weights(plan.off[ax, lo:hi], plan.w, plan.beta)
        if idx is None:
            idx, wt = r, wa
        else:
            shape = (hi - lo,) + (1,) * ax + (plan.w,)
            idx = idx[..., None] * n + r.reshape(shape)
            wt = wt[..., None] * wa.reshape(shape)
    return idx, wt


def _spread_plain(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    B, d = c.shape[0], plan.d
    perm = plan.perm.long()
    g = torch.zeros((B, math.prod(plan.nf), 2), dtype=c.dtype,
                    device=c.device)
    for lo, hi in _chunks(plan):
        idx, wt = _taps(plan, lo, hi)
        cs = c[:, perm[lo:hi]].reshape((B, hi - lo) + (1,) * d + (2,))
        vals = cs * wt[None, ..., None]
        g.index_add_(1, idx.reshape(-1), vals.reshape(B, -1, 2))
    return g.reshape((B,) + plan.nf + (2,))


def _interp_plain(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    B, d = g.shape[0], plan.d
    perm = plan.perm.long()
    flat = g.reshape(B, -1, 2)
    out = torch.empty((B, plan.M, 2), dtype=g.dtype, device=g.device)
    for lo, hi in _chunks(plan):
        idx, wt = _taps(plan, lo, hi)
        vals = flat[:, idx.reshape(-1)].reshape(
            (B, hi - lo) + (plan.w,) * d + (2,))
        out[:, perm[lo:hi]] = torch.sum(vals * wt[None, ..., None],
                                        dim=tuple(range(2, 2 + d)))
    return out


def _plain_check(a: torch.Tensor, plan: Plan, d: int):
    if plan.d != d:
        raise ValueError(f"a {plan.d}-D plan given to a {d}-D function")


def nufft_spread2_plain(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Strengths ``(B, M, 2)`` -> grid ``(B, n1, n2, 2)``, by ``index_add_``
    of the w^2 tap products."""
    _plain_check(c, plan, 2)
    return _spread_plain(c, plan)


def nufft_interp2_plain(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Grid ``(B, n1, n2, 2)`` -> values ``(B, M, 2)``, by a gather of the
    w^2 taps and a weighted sum."""
    _plain_check(g, plan, 2)
    return _interp_plain(g, plan)


def nufft_spread3_plain(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Strengths ``(B, M, 2)`` -> grid ``(B, n1, n2, n3, 2)``, by
    ``index_add_`` of the w^3 tap products."""
    _plain_check(c, plan, 3)
    return _spread_plain(c, plan)


def nufft_interp3_plain(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Grid ``(B, n1, n2, n3, 2)`` -> values ``(B, M, 2)``, by a gather of
    the w^3 taps and a weighted sum."""
    _plain_check(g, plan, 3)
    return _interp_plain(g, plan)


# ------------------------------------------------------------ CUDA kernels --

@functools.cache
def _library():
    """Compile ``csrc/nufft.cu`` (once per source hash) and load it."""
    lib, log = compile_and_load("nufft.cu")
    for fn in (lib.nufft_spread2_launch, lib.nufft_interp2_launch):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.nufft_spread3_launch, lib.nufft_interp3_launch):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nufft_error_string.argtypes = [ctypes.c_int]
    lib.nufft_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build and load the kernels; returns the compiler's output (empty
    when the library was already built)."""
    return _library()[1]


def _check(a: torch.Tensor, plan: Plan, d: int, core: tuple):
    _plain_check(a, plan, d)
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


def _launch(fn, src: torch.Tensor, dst: torch.Tensor, plan: Plan):
    lib = _library()[0]
    if plan.d == 2:
        geom = (*plan.nf, plan.nbins[1])
    else:
        geom = (*plan.nf, *plan.bins, *plan.nbins[1:])
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(lib, fn)(
            src.data_ptr(), dst.data_ptr(), plan.perm.data_ptr(),
            plan.i0.data_ptr(), plan.off.data_ptr(), plan.sub.data_ptr(),
            plan.sub.shape[0], src.shape[0], plan.M, *geom,
            plan.w, plan.beta, int(src.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.nufft_error_string(err).decode()})")


def _spread(wrapper, c: torch.Tensor, plan: Plan, d: int) -> torch.Tensor:
    if c.device.type == "cpu":
        _plain_check(c, plan, d)
        return _spread_plain(c, plan)
    _check(c, plan, d, (plan.M, 2))
    g = torch.zeros((c.shape[0],) + plan.nf + (2,), dtype=c.dtype,
                    device=c.device)
    if plan.M == 0:
        return g
    wrapper.launches += 1
    _launch(f"nufft_spread{d}_launch", c, g, plan)
    return g


def _interp(wrapper, g: torch.Tensor, plan: Plan, d: int) -> torch.Tensor:
    if g.device.type == "cpu":
        _plain_check(g, plan, d)
        return _interp_plain(g, plan)
    _check(g, plan, d, plan.nf + (2,))
    out = torch.empty((g.shape[0], plan.M, 2), dtype=g.dtype,
                      device=g.device)
    if plan.M == 0:
        return out
    wrapper.launches += 1
    _launch(f"nufft_interp{d}_launch", g, out, plan)
    return out


def nufft_spread2(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Spread of ``c`` ``(B, M, 2)`` onto ``(B, n1, n2, 2)``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return _spread(nufft_spread2, c, plan, 2)


def nufft_interp2(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Interp of the grid ``g`` ``(B, n1, n2, 2)`` at the plan's points:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    return _interp(nufft_interp2, g, plan, 2)


def nufft_spread3(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Spread of ``c`` ``(B, M, 2)`` onto ``(B, n1, n2, n3, 2)``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return _spread(nufft_spread3, c, plan, 3)


def nufft_interp3(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Interp of the grid ``g`` ``(B, n1, n2, n3, 2)`` at the plan's
    points: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _interp(nufft_interp3, g, plan, 3)


nufft_spread2.launches = 0
nufft_interp2.launches = 0
nufft_spread3.launches = 0
nufft_interp3.launches = 0
