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
- 1))`` on |z| <= 1 and ``z(t) = (t - off) * 2 / w``.  Values are complex
as ``(..., 2)`` real pairs: strengths ``(B, M, 2)`` and grids ``(B, *nf,
2)``, points in their original order.

* :func:`plan2` / :func:`plan3` — the plan, built once on the points'
  device in float64: left taps and offsets per axis, the stable sort by
  bin (32x32 in 2-D, :func:`bin3` in 3-D) and within a bin by spread bin
  (``SPREAD_BIN`` cells a side), each spread bin's first point and count,
  the interp's subproblems (bins cut into runs of at most ``MAX_SUB``
  points) and the spread's tasks (:func:`spread_tasks`: the grid cut into
  bins, the bins among many points into parts).  Sorting and counting use
  library calls (``argsort``, ``bincount``, ``cumsum``);
* :func:`tap_shape` / :func:`interp_subgrid` — the interp kernel's
  geometry (how a point's taps are read, its subgrid's sides and pitch),
  mirrored from ``csrc/nufft.cu`` for the CPU tests;
* :func:`nufft_spread2_plain` / :func:`nufft_interp2_plain` and the ``3``
  forms — the plain PyTorch versions: ``index_add_`` of the w^d tap
  products, and a gather and sum, over chunks of points (at most
  ``TAPS_PER_CHUNK`` taps a chunk, which bounds their memory).  They run
  in the plan's dtype; a float64 reference of a float32 plan's sums is
  ``plain(a.double(), plan.astype(torch.float64))``;
* :func:`nufft_spread2` / :func:`nufft_interp2` and the ``3`` forms — the
  wrappers.  On a CUDA tensor they launch the hand-written kernels of
  ``csrc/nufft.cu`` (or raise); on a CPU tensor they run the plain
  versions.  ``.launches`` counts kernel launches.  The spread kernel
  writes every cell once, without atomics, so it needs no zeroed grid;
  both kernels give the same bits on every launch.

The kernels take float32 and float64, 2 to 16 taps and any grid size.  An
empty point set (M = 0) launches nothing: spread gives zeros, interp an
empty result.

d = 1 has no kernel (the JAX package has no Pallas kernel for it either):
:func:`plan1` and :func:`nufft_spread1_plain` / :func:`nufft_interp1_plain`
run the plain versions on either device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pyxu_tpu_torch.ops._build import compile_and_load
from pyxu_tpu_torch.ops._guard import refuse_autodiff

__all__ = [
    "Plan",
    "plan2",
    "plan3",
    "plan1",
    "bin3",
    "neighbourhood",
    "spread_tasks",
    "tap_shape",
    "interp_subgrid",
    "es_weights",
    "nufft_spread2_plain",
    "nufft_interp2_plain",
    "nufft_spread1_plain",
    "nufft_interp1_plain",
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
THREADS = 256       # NU_THREADS: threads of a spread block
MAX_RUN = {2: 4, 3: 16}     # NU_RMAX2, NU_RMAX: most cells of one spread
                            # thread's patch
SPLIT = 8192        # spread: candidate points a task takes before its bin
                    # is cut into parts
SPREAD_BIN = {2: 8, 3: 4}   # spread bin side per axis (within a bin)
MAX_SEG = 1024      # NU_MAXSEG: most spread bins one task reads
SMEM_MAX = 232_448  # shared memory one block may opt in to (227 KB)
TAPS_PER_CHUNK = 1 << 24    # plain versions: tap products per chunk
GROUP = 16          # NU_GROUP: interp lanes that sum one point's taps
INTERP_GROUP = {2: False, 3: True}  # NuInterpFrame: taps by groups of
                                    # GROUP lanes (else a thread a point)
_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Geometry of M points on the periodic fine grid ``nf`` (d = 2 or 3
    axes; d = 1 from :func:`plan1`, one bin and no tasks).

    ``bins``: the bin's side per axis; ``nbins``: bins per axis.  ``perm``
    (M,) int32: the original index of each sorted point.  ``i0`` (d, M)
    int32: each sorted point's left tap per axis, shifted by whole periods
    so that ``i0 + w // 2`` lies in ``[0, n)``.  ``off`` (d, M) in
    ``dtype``: ``x / h - i0`` in ``(w/2 - 1, w/2]``, from float64.  ``sub``
    (n_sub, 3) int32: per subproblem the row-major bin index, its first
    sorted point and its point count (the interp's blocks).

    Within a bin the points are sorted by spread bin (``sbins`` per axis,
    ``nsbins`` of them per axis over the grid; a bin holds whole spread
    bins).  ``sbstart`` / ``sbcount`` (n_spread_bins,) int32: each
    row-major spread bin's first sorted point and point count.  ``tasks``
    (n_tasks, 4 d + 3) int32: the spread's blocks (:func:`spread_tasks`).
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
    sbins: tuple
    nsbins: tuple
    sbstart: torch.Tensor
    sbcount: torch.Tensor
    tasks: torch.Tensor

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

    An interp block holds the bin's subgrid, the bin plus a w - 1 halo per
    axis, in shared memory: ``(b1 + w - 1)(b2 + w - 1)(b3 + w - 1)``
    complex cells, 8 B each in float32 and 16 B in float64.  A spread task
    is the bin (or a part of it), and every point within w - 1 cells of
    its edge is staged by each task it reaches: the larger the bin, the
    smaller that share.  Rule: the first of 16x16x16, 16x16x8 and 8x8x8
    whose subgrid fits half of the 227 KB a block may opt in to (two
    blocks an SM), else 8x8x8, whose subgrid needs at most 23^3 x 16 B =
    194,672 B (w = 16, float64).  At w = 7 in float32, 16^3 bins spread and
    interpolate 2^21 points on a 256^3 grid faster than cuFINUFFT's 3-D
    default 16x16x2 or than 8x8x8 on an H100 (``bench_nufft3_bins.py``;
    times in PERF.md).
    """
    cell = 8 if dtype == torch.float32 else 16
    for bins in ((16, 16, 16), (16, 16, 8)):
        if math.prod(b + w - 1 for b in bins) * cell <= SMEM_MAX // 2:
            return bins
    return (8, 8, 8)


def tap_shape(w: int, dtype: torch.dtype) -> dict:
    """How the interp kernel's ``GROUP`` lanes read one point's taps
    (``NuTapShape`` of ``csrc/nufft.cu``): each lane reads ``C`` cells of
    the last axis at once (16 bytes: two cells in float32 up to w = 7,
    else one cell of 8 or 16 bytes) from an aligned start, ``L`` lanes a
    row, ``R = GROUP / L`` rows a step, ``K`` steps a plane; one
    shared-memory wavefront serves ``PH`` lanes.  ``E`` cells make 16
    bytes; in float32 the subgrid's last axis starts ``X0`` cells left of
    the bin's halo, so that its rows start on 16-byte boundaries."""
    size = 4 if dtype == torch.float32 else 8
    C = 2 if size == 4 and w <= 7 else 1
    L = 2
    while L < (w + 2 * C - 2) // C:
        L *= 2
    R = GROUP // L
    E = 16 // (2 * size)
    return dict(C=C, L=L, R=R, K=-(-w // R), PH=128 // (2 * C * size), E=E,
                X0=(w // 2) % 2 if E == 2 else 0)


def interp_subgrid(bins, w: int, dtype: torch.dtype) -> dict:
    """The interp block's subgrid for bins ``bins`` (d = its length) and
    ``w`` taps: the tap body (``INTERP_GROUP``), the sides loaded per axis
    (``b + w - 1``; the last ``X0`` more, rounded up to 16 bytes), the row
    pitch in cells and the shared memory of one subgrid.  Where one
    wavefront serves several rows of a group (``L < PH``), the pitch puts
    those rows on disjoint banks."""
    sh = tap_shape(w, dtype)
    C, L, PH, E = sh["C"], sh["L"], sh["PH"], sh["E"]
    group = INTERP_GROUP[len(bins)]
    sides = [b + w - 1 for b in bins]
    sides[-1] = -(-(sides[-1] + sh["X0"]) // E) * E
    pitch = sides[-1]
    while group and L < PH and (pitch // C) % PH != L:
        pitch += E
    cell = 8 if dtype == torch.float32 else 16
    return dict(group=group, sides=tuple(sides), pitch=pitch,
                smem=math.prod(sides[:-1]) * pitch * cell)


def neighbourhood(o, e, n: int, b: int, nb: int, w: int):
    """Bins along one axis whose points can tap the cells ``o .. o + e -
    1`` (tensors) of an axis of ``n`` cells in ``nb`` bins of ``b``: the
    run ``lo, lo + 1, ..., lo + cnt - 1`` (mod ``nb``), ``cnt <= nb``, so
    no bin comes twice.

    A point's left tap is ``base - w // 2`` with ``base`` in ``[0, n)``,
    its bin ``base // b``; it taps cell ``c`` when ``base`` lies in
    ``[c - (w - 1 - w // 2), c + w // 2]`` (mod ``n``).
    """
    x0 = torch.remainder(o - (w - 1 - w // 2), n)
    x1 = x0 + e + w - 2                 # the last base, < 2 n unless all
    lo = x0 // b
    cnt = torch.where(x1 < n, x1 // b - lo + 1,
                      nb - lo + (x1 - n) // b + 1)
    full = (e + w - 1 >= n) | (cnt >= nb)
    return torch.where(full, 0, lo), torch.where(full, nb, cnt)


class _TaskGeometry:
    """The spread's task decomposition (:func:`spread_tasks`) for one grid,
    tap count, bin shape and spread-bin shape.  What depends on the grid
    alone is computed on the host; what depends on the points, on their
    device with no host read."""

    def __init__(self, nf, w: int, bins, sbins):
        if any(b & (b - 1) for b in bins):
            raise ValueError(f"bins {bins}: the spread takes powers of 2")
        self.nf, self.w, self.bins = tuple(nf), int(w), tuple(bins)
        self.sbins = tuple(sbins)
        self.nbins = tuple(-(-n // b) for n, b in zip(nf, bins))
        self.nsbins = tuple(-(-n // b) for n, b in zip(nf, sbins))
        rest = math.prod(bins[1:])
        # planes of the widest task: at most MAX_RUN cells a thread, and
        # no run longer than the last axis' bin
        cap = THREADS * min(MAX_RUN[len(bins)], bins[-1]) // rest
        if cap < 1:
            raise ValueError(f"bins {bins}: a plane exceeds one block")
        self.p_full = min(bins[0], 1 << (cap.bit_length() - 1))
        # per axis and bin coordinate, the spread bins a whole bin reads
        self.bin_ranges = [self._ranges(ax, *self._bin_origin(
            torch.arange(nb), ax)) for ax, nb in enumerate(self.nbins)]
        seg = math.prod(int(cnt.max()) for _, cnt in self.bin_ranges)
        if seg > MAX_SEG:
            raise ValueError(f"a task would read {seg} spread bins, more "
                             f"than {MAX_SEG}")

    def _ranges(self, ax: int, o, e):
        return neighbourhood(o, e, self.nf[ax], self.sbins[ax],
                             self.nsbins[ax], self.w)

    def _bin_origin(self, q, ax: int):
        o = q * self.bins[ax]
        return o, torch.clamp(self.nf[ax] - o, max=self.bins[ax])

    def split(self, sbcount: torch.Tensor):
        """Per bin: its task count, the tasks' planes along axis 0 and rows
        along axis 1, and the candidate points of one task (the sort key of
        the tasks).  A bin whose spread bins hold ``cand`` points is cut
        into the least power of 2 of tasks, ``parts``, with ``cand / parts
        <= SPLIT``: first into slabs of fewer planes, down to one, then (in
        3-D) each plane into strips of fewer rows, down to one."""
        dev, d = sbcount.device, len(self.nf)
        # sums over each bin's box of spread bins, axis by axis
        cand = sbcount.reshape(self.nsbins)
        for ax, (lo, cnt) in enumerate(self.bin_ranges):
            k = torch.arange(int(cnt.max()))
            idx = ((lo[:, None] + k) % self.nsbins[ax]).to(dev)
            mask = (k < cnt[:, None]).to(device=dev, dtype=cand.dtype)
            cand = (cand.movedim(ax, -1)[..., idx] * mask).sum(-1) \
                .movedim(-1, ax)
        cand = cand.reshape(-1)
        rows = self.bins[1] if d == 3 else 1
        most = self.p_full * rows
        need = (cand + SPLIT - 1) // SPLIT
        parts = torch.ones_like(cand)
        p = 2
        while p <= most:
            parts = torch.where(need > p // 2, p, parts)
            p *= 2
        planes = torch.clamp(self.p_full // parts, min=1)
        rows = torch.clamp(rows * self.p_full // parts, max=rows)
        q = torch.arange(cand.numel(), device=dev)
        e0 = self._bin_origin(q // math.prod(self.nbins[1:]), 0)[1]
        n = (e0 + planes - 1) // planes
        if d == 3:
            e1 = self._bin_origin(q // self.nbins[2] % self.nbins[1], 1)[1]
            n = n * ((e1 + rows - 1) // rows)
        return n, planes, rows, cand // parts

    def tasks(self, ntask, planes, rows, work, n_tasks: int) -> torch.Tensor:
        """The task table, heaviest first (see :func:`spread_tasks`)."""
        dev, d = ntask.device, len(self.nf)
        tb = torch.repeat_interleave(
            torch.arange(ntask.numel(), device=dev), ntask,
            output_size=n_tasks)
        first = torch.cumsum(ntask, 0) - ntask
        s = torch.arange(n_tasks, device=dev) - first[tb]
        P, V = planes[tb], rows[tb]
        coords, rem = [], tb
        for ax in reversed(range(d)):
            coords.append(rem % self.nbins[ax])
            rem = rem // self.nbins[ax]
        coords.reverse()
        cols = [[] for _ in range(4)]
        for ax in range(d):
            o, e = self._bin_origin(coords[ax], ax)
            if ax < 2 and (ax == 0 or d == 3):
                # slab s // strips, strip s % strips of the bin
                e1 = self._bin_origin(coords[1], 1)[1]
                strips = (e1 + V - 1) // V if d == 3 else 1
                step, k = (P, s // strips) if ax == 0 else (V, s % strips)
                o = o + k * step
                e = torch.clamp(self.nf[ax] - o, max=step)
                lo, cnt = self._ranges(ax, o, e)
            else:
                lo, cnt = (r.to(dev)[coords[ax]]
                           for r in self.bin_ranges[ax])
            for col, v in zip(cols, (o, e, lo, cnt)):
                col.append(v)
        cells = P * (V if d == 3 else 1) * self.bins[-1]
        run = torch.clamp(cells // THREADS, min=1)
        t = torch.stack(sum(cols, []) + [P, V, run], dim=1)
        order = torch.argsort(work[tb], descending=True, stable=True)
        return t[order].to(torch.int32).contiguous()


def spread_tasks(plan: "Plan") -> dict:
    """The spread's tasks of ``plan``, one CUDA block each, as named
    columns (``plan.tasks`` decoded).

    Every grid cell belongs to one task.  A task is a box of cells: its
    ``origin`` and ``extent`` per axis, ``(n_tasks, d)``; a whole bin, or
    where the points around the bin exceed ``SPLIT`` a part of it:
    ``planes`` planes along axis 0 and (3-D) ``rows`` rows along axis 1,
    powers of 2 (``extent`` is smaller at the grid's end).  ``lo`` and
    ``cnt`` per axis: the spread bins whose points it reads
    (:func:`neighbourhood` in units of ``plan.sbins``; the box of them, at
    most ``MAX_SEG``).  Each thread owns a patch of ``run`` cells (a power
    of 2, at most ``MAX_RUN[d]``): ``min(run, 4)`` along the last axis by
    ``run / min(run, 4)`` rows along axis 1 (3-D); ``planes * rows *
    bins[-1] / run <= THREADS``.  Tasks come heaviest first, by candidate
    points a task.
    """
    t, d = plan.tasks.long(), plan.d
    return dict(origin=t[:, :d], extent=t[:, d:2 * d], lo=t[:, 2 * d:3 * d],
                cnt=t[:, 3 * d:4 * d], planes=t[:, 4 * d],
                rows=t[:, 4 * d + 1], run=t[:, 4 * d + 2])


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
    sbins = tuple(min(SPREAD_BIN[d], b) for b in bins)
    geom = _TaskGeometry(nf, w, bins, sbins)
    nbins, nsbins = geom.nbins, geom.nsbins
    cols_i0, cols_off = [], []
    binid = torch.zeros(M, dtype=torch.int64, device=dev)
    local = torch.zeros_like(binid)        # the spread bin within the bin
    sbid = torch.zeros_like(binid)         # the spread bin in the grid
    for ax, (n, b, nb, sb, ns) in enumerate(zip(nf, bins, nbins, sbins,
                                                nsbins)):
        xs = x[:, ax] / (2 * math.pi / n)
        i0 = torch.ceil(xs - w / 2.0)
        cols_off.append(xs - i0)
        base = torch.remainder(i0.to(torch.int64) + hw, n)   # in [0, n)
        cols_i0.append(base - hw)
        binid = binid * nb + base // b
        local = local * (b // sb) + (base % b) // sb
        sbid = sbid * ns + base // sb
    per_bin = math.prod(b // sb for b, sb in zip(bins, sbins))
    key = binid * per_bin + local
    perm = torch.argsort(key, stable=True)
    counts = torch.bincount(binid, minlength=math.prod(nbins))
    starts = torch.cumsum(counts, 0) - counts
    kcount = torch.bincount(key, minlength=math.prod(nbins) * per_bin)
    # each spread bin's key, from its coordinates
    gkey = torch.zeros((), dtype=torch.int64, device=dev)
    gloc = torch.zeros((), dtype=torch.int64, device=dev)
    for b, nb, sb, ns in zip(bins, nbins, sbins, nsbins):
        c = torch.arange(ns, device=dev)
        gkey = gkey[..., None] * nb + c // (b // sb)
        gloc = gloc[..., None] * (b // sb) + c % (b // sb)
    gkey = (gkey * per_bin + gloc).reshape(-1)
    sbstart = (torch.cumsum(kcount, 0) - kcount)[gkey]
    sbcount = torch.bincount(sbid, minlength=math.prod(nsbins))
    nsub_bin = (counts + MAX_SUB - 1) // MAX_SUB
    ntask, planes, rows, work = geom.split(sbcount)
    # the plan's one host read: the interp's and the spread's block counts
    n_sub, n_tasks = torch.stack([nsub_bin.sum(), ntask.sum()]).tolist()
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
        sub=sub.to(torch.int32).contiguous(), sbins=sbins, nsbins=nsbins,
        sbstart=sbstart.to(torch.int32), sbcount=sbcount.to(torch.int32),
        tasks=geom.tasks(ntask, planes, rows, work, n_tasks))


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


def plan1(x: torch.Tensor, nf, w: int, beta: float,
          dtype: torch.dtype) -> Plan:
    """Plan of the points ``x`` ((M, 1) float64, folded into [0, 2 pi)) on
    the ring ``nf = (n,)``: left taps and offsets, in the points' order
    (one bin, no tasks).  No kernel takes d = 1: the plain versions
    (:func:`nufft_spread1_plain`, :func:`nufft_interp1_plain`) read it on
    either device."""
    if x.dtype != torch.float64 or x.ndim != 2 or x.shape[1] != 1:
        raise ValueError("x must be an (M, 1) float64 tensor")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: want float32 or float64")
    (n,) = (int(v) for v in nf)
    dev, M, hw = x.device, x.shape[0], w // 2
    xs = x[:, 0] / (2 * math.pi / n)
    i0 = torch.ceil(xs - w / 2.0)
    base = torch.remainder(i0.to(torch.int64) + hw, n)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    return Plan(
        nf=(n,), w=int(w), beta=float(beta), M=M, bins=(n,), nbins=(1,),
        perm=torch.arange(M, dtype=torch.int32, device=dev),
        i0=(base - hw)[None].to(torch.int32), off=(xs - i0)[None].to(dtype),
        sub=none.reshape(0, 3), sbins=(n,), nsbins=(1,), sbstart=none,
        sbcount=none, tasks=none.reshape(0, 7))


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


def _taps(plan: Plan, sel):
    """Flat grid index and weight ``(m, w, ..., w)`` of the taps of the
    sorted points ``sel`` (a slice or an index tensor)."""
    t = torch.arange(plan.w, device=plan.device)
    idx = wt = None
    for ax, n in enumerate(plan.nf):
        r = (plan.i0[ax, sel].long()[:, None] + t) % n
        wa = es_weights(plan.off[ax, sel], plan.w, plan.beta)
        if idx is None:
            idx, wt = r, wa
        else:
            shape = (r.shape[0],) + (1,) * ax + (plan.w,)
            idx = idx[..., None] * n + r.reshape(shape)
            wt = wt[..., None] * wa.reshape(shape)
    return idx, wt


def _bin_order(plan: Plan) -> torch.Tensor:
    """The sorted points bin by bin, each bin's in their original order:
    the plain spread's order of summation, which does not depend on how a
    bin's points are sorted for the kernels."""
    base = plan.i0.long() + plan.w // 2
    binid = torch.zeros(plan.M, dtype=torch.int64, device=plan.device)
    for ax, (b, nb) in enumerate(zip(plan.bins, plan.nbins)):
        binid = binid * nb + base[ax] // b
    return torch.argsort(binid * max(plan.M, 1) + plan.perm.long())


def _spread_plain(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    B, d = c.shape[0], plan.d
    order = _bin_order(plan)
    perm = plan.perm.long()
    g = torch.zeros((B, math.prod(plan.nf), 2), dtype=c.dtype,
                    device=c.device)
    for lo, hi in _chunks(plan):
        sel = order[lo:hi]
        idx, wt = _taps(plan, sel)
        cs = c[:, perm[sel]].reshape((B, hi - lo) + (1,) * d + (2,))
        vals = cs * wt[None, ..., None]
        g.index_add_(1, idx.reshape(-1), vals.reshape(B, -1, 2))
    return g.reshape((B,) + plan.nf + (2,))


def _interp_plain(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    B, d = g.shape[0], plan.d
    perm = plan.perm.long()
    flat = g.reshape(B, -1, 2)
    out = torch.empty((B, plan.M, 2), dtype=g.dtype, device=g.device)
    for lo, hi in _chunks(plan):
        idx, wt = _taps(plan, slice(lo, hi))
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


def nufft_spread1_plain(c: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Strengths ``(B, M, 2)`` -> ring ``(B, n, 2)``, by ``index_add_`` of
    the w taps (d = 1 has no kernel: this runs on either device)."""
    _plain_check(c, plan, 1)
    return _spread_plain(c, plan)


def nufft_interp1_plain(g: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Ring ``(B, n, 2)`` -> values ``(B, M, 2)``, by a gather of the w taps
    and a weighted sum (either device)."""
    _plain_check(g, plan, 1)
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
def _library(defines: tuple = ()):
    """Compile ``csrc/nufft.cu`` (once per source hash and ``defines``)
    and load it."""
    lib, log = compile_and_load("nufft.cu", defines)
    tail = [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    for fn, n_int in ((lib.nufft_spread2_launch, 10),
                      (lib.nufft_spread3_launch, 13)):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int + tail
        fn.restype = ctypes.c_int
    for fn, n_int in ((lib.nufft_interp2_launch, 7),
                      (lib.nufft_interp3_launch, 12)):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int + tail
        fn.restype = ctypes.c_int
    lib.nufft_error_string.argtypes = [ctypes.c_int]
    lib.nufft_error_string.restype = ctypes.c_char_p
    return lib, log


def build() -> str:
    """Build and load the kernels; returns the compiler's output (empty
    when the library was already built)."""
    return _library()[1]


def _check(a: torch.Tensor, plan: Plan, d: int, core: tuple):
    refuse_autodiff(f"nufft ({d}-D)", a)
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


def _launch(fn, src: torch.Tensor, dst: torch.Tensor, plan: Plan,
            lib=None):
    lib = lib or _library()[0]
    if fn.startswith("nufft_spread"):
        ptrs = (plan.sbstart.data_ptr(), plan.sbcount.data_ptr(),
                plan.tasks.data_ptr(), plan.tasks.shape[0])
        geom = (*plan.nf, *plan.bins, *plan.nsbins)
    else:
        ptrs = (plan.sub.data_ptr(), plan.sub.shape[0])
        geom = ((*plan.nf, plan.nbins[1]) if plan.d == 2
                else (*plan.nf, *plan.bins, *plan.nbins[1:]))
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(lib, fn)(
            src.data_ptr(), dst.data_ptr(), plan.perm.data_ptr(),
            plan.i0.data_ptr(), plan.off.data_ptr(), *ptrs, src.shape[0],
            plan.M, *geom, plan.w, plan.beta,
            int(src.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.nufft_error_string(err).decode()})")


def _spread(wrapper, c: torch.Tensor, plan: Plan, d: int) -> torch.Tensor:
    if c.device.type == "cpu":
        _plain_check(c, plan, d)
        return _spread_plain(c, plan)
    _check(c, plan, d, (plan.M, 2))
    shape = (c.shape[0],) + plan.nf + (2,)
    if plan.M == 0:
        return torch.zeros(shape, dtype=c.dtype, device=c.device)
    # the kernel writes every cell once
    g = torch.empty(shape, dtype=c.dtype, device=c.device)
    wrapper.launches += 1
    _launch(f"nufft_spread{d}_launch", c, g, plan)
    return g


def _interp(wrapper, g: torch.Tensor, plan: Plan, d: int) -> torch.Tensor:
    if g.device.type == "cpu":
        _plain_check(g, plan, d)
        return _interp_plain(g, plan)
    _check(g, plan, d, plan.nf + (2,))
    if g.data_ptr() % (2 * g.element_size()):
        # the kernel reads whole (re, im) cells of 8 or 16 bytes
        raise ValueError("the grid must start on a whole (re, im) cell")
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
