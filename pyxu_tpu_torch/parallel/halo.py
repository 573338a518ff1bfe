"""Halo-exchange stencils over a mesh axis (counterpart of
``pyxu_tpu/parallel/halo.py``).

The image is sharded along one spatial axis; each rank receives
``halo``-wide ghost strips from its ring neighbours (``batch_isend_irecv``
in place of ``lax.ppermute``), correlates its extended block and keeps its
own rows.  Global boundary modes ``constant`` and ``wrap`` are exact (zero
ghosts / ring ghosts); the adjoint is the same machinery with the flipped
kernel, exact for both modes.

On a 2-D separable f32/f64 kernel set the local correlation runs the
stencil kernel (``ops/stencil.py``, ``csrc/stencil.cu``) in ``constant``
mode on the extended block: its core rows see only rows of the block,
since the halo covers the kernel's reach.  For ``wrap`` the unsharded axis
is padded circularly first and trimmed after.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from pyxu_tpu_torch.abc.operator import SquareOp
from pyxu_tpu_torch.operator.linop.pad import pad_axis
from pyxu_tpu_torch.operator.linop.stencil import (_canonical_kernels, _corr,
                                                   _sep_taps)
from pyxu_tpu_torch.ops import stencil as _kern
from pyxu_tpu_torch.parallel.mesh import axis_index, from_local, to_local
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = ["halo_exchange", "ShardedStencil"]

_MODES = ("constant", "wrap")


def halo_exchange(x: torch.Tensor, lo: int, hi: int, axis: int, mesh,
                  mode: str = "constant", mesh_axis: str = None):
    """Append ghost strips from the ring neighbours on ``mesh[mesh_axis]``
    along ``axis`` of this rank's block ``x``.

    Returns the block padded to ``n_local + lo + hi`` along ``axis``:
    ``lo`` rows of the previous rank's tail before it, ``hi`` rows of the
    next rank's head after it.  ``mode='constant'``: zeros at the global
    edges; ``'wrap'``: the ring.  A rank never sends to itself (gloo and
    NCCL refuse it): on a mesh axis of one rank, ``wrap`` takes its own
    tail and head.  All sends and receives of the exchange go in one
    ``batch_isend_irecv``, tagged, in one order on every rank, so that with
    two ranks, where both neighbours are one rank, they pair up.
    """
    if mode not in _MODES:
        raise ValueError(f"halo_exchange supports 'constant'/'wrap' "
                         f"boundaries, got {mode!r}")
    n_loc = x.shape[axis]
    if max(lo, hi) > n_loc:
        raise ValueError(f"halo ({lo},{hi}) exceeds the local shard "
                         f"({n_loc} rows along axis {axis})")
    ax = axis_index(mesh, mesh_axis)
    n, me = mesh.size(ax), mesh.get_local_rank(ax)
    wrap = mode == "wrap"

    def strip(start, size):
        return x.narrow(axis, start, size).contiguous()

    def zeros(size):
        shape = list(x.shape)
        shape[axis] = size
        return x.new_zeros(shape)

    if n == 1:
        ghost_lo = (strip(n_loc - lo, lo) if wrap else zeros(lo)) if lo \
            else None
        ghost_hi = (strip(0, hi) if wrap else zeros(hi)) if hi else None
    else:
        group = mesh.get_group(ax)

        def peer(i):
            return dist.get_global_rank(group, i % n)

        ops, ghost_lo, ghost_hi = [], None, None
        if lo:      # tails move up the ring: mine to the next rank's lo
            if wrap or me < n - 1:
                ops.append(dist.P2POp(dist.isend, strip(n_loc - lo, lo),
                                      peer(me + 1), group, tag=0))
            ghost_lo = zeros(lo)
            if wrap or me > 0:
                ops.append(dist.P2POp(dist.irecv, ghost_lo, peer(me - 1),
                                      group, tag=0))
        if hi:      # heads move down: mine to the previous rank's hi
            if wrap or me > 0:
                ops.append(dist.P2POp(dist.isend, strip(0, hi),
                                      peer(me - 1), group, tag=1))
            ghost_hi = zeros(hi)
            if wrap or me < n - 1:
                ops.append(dist.P2POp(dist.irecv, ghost_hi, peer(me + 1),
                                      group, tag=1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    parts = [p for p in (ghost_lo, x, ghost_hi) if p is not None]
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


class ShardedStencil(SquareOp):
    """Stencil with explicit halo exchange along one sharded spatial axis.

    ``apply``/``adjoint`` take this rank's block of the input (a
    ``DTensor`` sharded on ``shard_axis``, or the global tensor, which is
    cut locally) and return a ``DTensor`` sharded the same way; the
    unsharded axes behave like :class:`Stencil` with the same mode.  Modes
    ``constant`` and ``wrap``, the two whose ghost semantics match shard
    halos exactly.  ``kernel_path``: ``"kernel"`` where the local
    correlation runs the stencil kernel (a 2-D separable kernel set of at
    most 32 taps an axis), else None.
    """

    def __init__(self, dim_shape, kernel, center, mesh,
                 shard_axis: int = 0, mesh_axis: str = None,
                 mode: str = "constant"):
        dim_shape = as_canonical_shape(dim_shape)
        super().__init__(dim_shape)
        if mode not in _MODES:
            raise ValueError(f"ShardedStencil supports modes {_MODES}, got "
                             f"{mode!r}")
        D = len(dim_shape)
        kc = _canonical_kernels(kernel, center, D)
        self._kernels = tuple(k for k, _ in kc)
        self._centers = tuple(c for _, c in kc)
        self._mesh = mesh
        self._ax = shard_axis % D
        self._max = axis_index(mesh, mesh_axis)
        self._mname = mesh_axis
        self._mode = mode
        n_dev = mesh.size(self._max)
        if dim_shape[self._ax] % n_dev:
            raise ValueError(f"axis {self._ax} ({dim_shape[self._ax]}) does "
                             f"not divide evenly over {n_dev} ranks")
        local = dim_shape[self._ax] // n_dev
        for k, c in kc:
            lo, hi = c[self._ax], k.shape[self._ax] - 1 - c[self._ax]
            if max(lo, hi) > local:
                raise ValueError(
                    f"kernel halo ({lo},{hi}) exceeds the local shard "
                    f"({local} rows) — use fewer ranks")
        l1 = 1.0
        for k in self._kernels:
            l1 *= float(np.sum(np.abs(k)))
        self._lipschitz = l1
        self._taps = _sep_taps(self._kernels, self._centers, "constant")
        self.kernel_path = "kernel" if self._taps is not None else None
        self._name = f"ShardedStencil[{mode}]"

    # -- local compute ------------------------------------------------------
    def _local_kernel(self, x, taps, nb):
        """The 2-D separable correlation of the block through the stencil
        kernel's wrapper: halo on the sharded axis, circular pad on the
        other in wrap mode, ``constant`` mode, core rows kept."""
        ax, other = nb + self._ax, nb + 1 - self._ax
        reach = ((taps.c0, len(taps.k0) - 1 - taps.c0),
                 (taps.c1, len(taps.k1) - 1 - taps.c1))
        lo, hi = reach[self._ax]
        olo, ohi = reach[1 - self._ax]
        n_ax, n_other = x.shape[ax], x.shape[other]
        x = halo_exchange(x, lo, hi, ax, self._mesh, self._mode, self._mname)
        if self._mode == "wrap":
            x = pad_axis(x, other, olo, ohi, "wrap")
        y = _kern.separable_correlate2d(x.contiguous(), taps)
        y = y.narrow(ax, lo, n_ax)
        if self._mode == "wrap":
            y = y.narrow(other, olo, n_other)
        return y

    def _local(self, x, kernels, centers, nb):
        """Correlate the local block kernel by kernel: halo along the
        sharded axis, plain pad on the others."""
        D = self.dim_rank
        ax_l = nb + self._ax
        for k, c in zip(kernels, centers):
            lo = [c[d] for d in range(D)]
            hi = [k.shape[d] - 1 - c[d] for d in range(D)]
            if lo[self._ax] or hi[self._ax]:
                x = halo_exchange(x, lo[self._ax], hi[self._ax], ax_l,
                                  self._mesh, self._mode, self._mname)
            for d in range(D):
                if d != self._ax:
                    x = pad_axis(x, nb + d, lo[d], hi[d], self._mode)
            x = _corr(x, k, ((0, 0),) * D)
        return x

    def _run(self, arr, kernels, centers, taps):
        nb = arr.ndim - self.dim_rank
        plc = [Replicate()] * self._mesh.ndim
        plc[self._max] = Shard(nb + self._ax)
        x = to_local(arr, self._mesh, tuple(plc))
        if taps is not None:
            y = self._local_kernel(x, taps, nb)
        else:
            y = self._local(x, kernels, centers, nb)
        return from_local(y.contiguous(), self._mesh, tuple(plc), arr.shape)

    def apply(self, arr):
        return self._run(arr, self._kernels, self._centers, self._taps)

    def adjoint(self, arr):
        # the flipped kernels and mirrored centres, computed once
        cached = getattr(self, "_adj_cache", None)
        if cached is None:
            kernels = tuple(np.flip(k) for k in reversed(self._kernels))
            centers = tuple(
                tuple(k.shape[d] - 1 - c[d] for d in range(k.ndim))
                for k, c in zip(reversed(self._kernels),
                                reversed(self._centers)))
            taps = None
            if self._taps is not None:
                t = self._taps
                taps = _kern.SepTaps(k0=t.k0[::-1], c0=len(t.k0) - 1 - t.c0,
                                     k1=t.k1[::-1], c1=len(t.k1) - 1 - t.c1,
                                     mode="constant")
            cached = self._adj_cache = (kernels, centers, taps)
        return self._run(arr, *cached)

    def _expr(self):
        return (f"ShardedStencil[{self._mode}, axis={self._ax}@"
                f"{self._mname or 0}]",)
