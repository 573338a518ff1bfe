"""Mesh-sharded NUFFT (counterpart of ``pyxu_tpu/parallel/nufft.py``).

* :class:`ShardedNUFFT`, type 1 with the points cut over a mesh axis: each
  rank plans and spreads only its own points (the port's
  ``nufft_spread2/3`` kernels on the card), one ``all_reduce`` sums the
  partial fine grids, and the FFT and mode extraction run replicated.
  Type 2 (the adjoint) is its transpose: modes to grid replicated, then
  each rank interpolates at its own points (``nufft_interp2/3``) with no
  collective; the output stays point-sharded.
* :class:`ShardedNUFFT3`, type 3 with the x-domain cut into one block a
  rank and the z-domain into Q blocks, every plan on one common fine
  grid: each rank runs its Q ``_NUFFT3`` plans, one ``all_reduce`` sums
  the partial results ``f[q] = sum_p A_pq c[p]``.

The fine grids are complex; they are reduced as their real views, which
NCCL and gloo both sum.  A sum over ranks changes the order of the
owner-computes spread's sums, so sharded and unsharded results agree to
rounding, not bit for bit.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.operator.linop.nufft import (_NUFFT3, _NUFFT12,
                                                 _es_params, _plan_dtype,
                                                 _t3_nf_np)
from pyxu_tpu_torch.parallel.mesh import (axis_index, chunk_bounds,
                                          from_local, mesh_device, place,
                                          to_full, to_local)
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.complex import view_as_complex, view_as_real

__all__ = ["ShardedNUFFT", "ShardedNUFFT3"]


def _host_points(x) -> np.ndarray:
    """(M, d) float64 host copy of a point cloud (a 1-D input is d = 1)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    return x[:, None] if x.ndim == 1 else x


def _balanced_parts_np(pts, n_parts: int):
    """Spatially coherent, count-balanced partition of a point cloud into
    ``n_parts`` index blocks: recursive proportional median splits along
    the widest axis (empty blocks where there are more parts than
    points)."""
    def rec(idx, n):
        if n == 1:
            return [idx]
        if len(idx) == 0:
            return [idx] * n
        nl = n // 2
        ext = pts[idx].max(axis=0) - pts[idx].min(axis=0)
        ax = int(np.argmax(ext))
        order = idx[np.argsort(pts[idx, ax], kind="stable")]
        cut = (len(idx) * nl) // n
        return rec(order[:cut], nl) + rec(order[cut:], n - nl)
    return rec(np.arange(pts.shape[0]), n_parts)


class _MeshAxis:
    """The mesh, one of its axes, this rank's index on it and its group."""

    def _init_axis(self, mesh, axis, device):
        self._mesh = mesh
        self._ax = axis_index(mesh, axis)
        self._axis = (mesh.mesh_dim_names or (None,))[self._ax]
        self._n = mesh.size(self._ax)
        self._rank = mesh.get_local_rank(self._ax)
        self._group = mesh.get_group(self._ax)
        return resolve_device(device if device is not None
                              else mesh_device(mesh))

    def _plc(self, shard_dim=None) -> tuple:
        plc = [Replicate()] * self._mesh.ndim
        if shard_dim is not None:
            plc[self._ax] = Shard(shard_dim)
        return tuple(plc)

    def _replicated(self, out: torch.Tensor):
        return place(out, self._mesh, self._plc())


class ShardedNUFFT(_MeshAxis, LinOp):
    """Point-sharded type-1 NUFFT (adjoint = type 2) over
    ``mesh[axis]``.

    dim (M, 2): nonuniform strengths, sharded along the point axis;
    codim (*N, 2): uniform modes, replicated.  M is padded to a multiple
    ``n Ml`` of the axis size with zero-strength points at the origin; rank
    r plans points ``[r Ml, (r + 1) Ml)``, the rows ``torch.chunk`` gives
    it.  ``kernel_path``: that of the rank's plan ("kernel" at d = 2, 3).
    """

    def __init__(self, x, N, mesh, axis: str = None, isign: int = +1,
                 eps: float = 1e-6, dtype=None, device=None):
        x = _host_points(x)
        M, d = x.shape
        dev = self._init_axis(mesh, axis, device)
        Ml = -(-M // self._n)
        xp = np.concatenate([x, np.zeros((Ml * self._n - M, d))], axis=0)
        self._M, self._Ml = M, Ml
        self._valid = chunk_bounds(M, self._n, self._rank)
        self._op = _NUFFT12(xp[self._rank * Ml:(self._rank + 1) * Ml], N,
                            isign=isign, eps=eps, dtype=dtype, device=dev)
        super().__init__((M, 2), tuple(self._op._N) + (2,))
        self._lipschitz = float(_math.sqrt(np.prod(self._op._N) * M))
        self.kernel_path = self._op.kernel_path
        self._name = f"ShardedNUFFT[d={d}, {self._n}x{self._axis}]"

    def _t1(self, a):
        """This rank's strengths (B, Ml, 2) -> replicated modes (B, *N, 2):
        the local spread, one all-reduce of the fine grid, the FFT."""
        op = self._op
        g = op._spread(a.contiguous(), op._plan)
        dist.all_reduce(g, group=self._group)
        return view_as_real(op._grid_to_modes(view_as_complex(g)))

    def apply(self, arr):
        nb = arr.ndim - 2
        a = to_local(arr, self._mesh, self._plc(nb))
        lo, hi = self._valid
        if hi - lo < self._Ml:      # the padded points' zero strengths
            pad = a.new_zeros(a.shape[:-2] + (self._Ml - (hi - lo), 2))
            a = torch.cat([a, pad], dim=-2)
        out = self._map_batched(self._t1, a, 2, self.codim_shape)
        return self._replicated(out)

    def adjoint(self, arr):
        f = to_full(arr).to(self._op._phihat.device)
        lo, hi = self._valid

        def t2(fb):
            return self._op._t2(view_as_complex(fb))[:, : hi - lo]
        out = self._map_batched(t2, f, self.codim_rank, (hi - lo, 2))
        nb = out.ndim - 2
        return from_local(out.contiguous(), self._mesh, self._plc(nb),
                          out.shape[:nb] + (self._M, 2))

    def _expr(self):
        return (self._name,)


class ShardedNUFFT3(_MeshAxis, LinOp):
    r"""Mesh-parallel domain-partitioned type-3 NUFFT.

    Partitioning (host, balanced median bisection):

    * the x-domain into ``P = mesh.size(axis)`` blocks, one a rank, each
      padded to the common size ``Mb``;
    * the z-domain into ``Q`` blocks (doubled until the common fine grid
      meets ``fft_mem_mb`` MB, 8 bytes a cell at float32, 16 at float64,
      or ``max_z_blocks`` is reached), padded to ``Kb``.

    Rank p builds its Q centred :class:`_NUFFT3` plans (x-block p, z-block
    q) on the elementwise-max fine grid ``nf``.  ``apply``: rank p runs
    them on its strengths and one ``all_reduce`` sums ``f[q] = sum_p A_pq
    c[p]``.  ``adjoint``: rank p forms its block ``c[p] = sum_q A_pq^H
    f[q]`` with no collective; the blocks are index sets, not a range of
    rows, so the global output is assembled by one ``all_reduce`` of the
    rows each rank fills.  Both outputs are replicated.
    """

    def __init__(self, x, z, mesh, axis: str = None, isign: int = +1,
                 eps: float = 1e-6, fft_mem_mb: float = 64.0,
                 max_z_blocks: int = 8, dtype=None, device=None):
        x, z = _host_points(x), _host_points(z)
        (M, d), (K, d2) = x.shape, z.shape
        if d != d2 or d > 3:
            raise ValueError(f"points of d = {d}, frequencies of d = {d2}: "
                             "want one d of at most 3")
        if M < 1 or K < 1:
            raise ValueError("ShardedNUFFT3 needs at least one point and "
                             "one frequency")
        dev = self._init_axis(mesh, axis, device)
        dtype = _plan_dtype(dtype)
        self._M, self._K, self._d = M, K, d

        w, _ = _es_params(eps)
        itemsize = 8 if dtype == torch.float32 else 16
        x_parts = _balanced_parts_np(x, self._n)
        max_q = max(1, min(int(max_z_blocks), K))
        Q = 1
        while True:
            z_parts = _balanced_parts_np(z, Q)
            nf = tuple(int(n) for n in np.max(
                [_t3_nf_np(x[ip], z[iq], w)
                 for ip in x_parts for iq in z_parts
                 if len(ip) and len(iq)], axis=0))
            if np.prod(nf) * itemsize / 1e6 <= fft_mem_mb or Q >= max_q:
                break
            Q = min(2 * Q, max_q)
        self._nf, self._Q = nf, Q

        # pad blocks to uniform sizes: padded slots repeat the block's first
        # point (extents and plan unchanged) and map to a dump row
        Mb = max(len(p) for p in x_parts)
        Kb = max(len(p) for p in z_parts)
        self._Mb, self._Kb = Mb, Kb

        def padded(parts, n_rows, dump, pts):
            idx = np.full((len(parts), n_rows), dump, np.int64)
            coord = np.empty((len(parts), n_rows, d))
            for i, ip in enumerate(parts):
                idx[i, :len(ip)] = ip
                fill = ip[:1] if len(ip) else np.zeros(1, np.int64)
                coord[i] = pts[np.r_[ip, np.repeat(fill, n_rows - len(ip))]]
            return idx, coord
        x_idx, x_coord = padded(x_parts, Mb, M, x)
        z_idx, z_coord = padded(z_parts, Kb, K, z)
        self._x_idx = torch.from_numpy(x_idx[self._rank]).to(dev)
        self._z_idx = torch.from_numpy(z_idx.reshape(-1)).to(dev)
        self._blocks = tuple(
            _NUFFT3(x_coord[self._rank], z_coord[q], isign=isign, eps=eps,
                    nf=nf, dtype=dtype, device=dev) for q in range(Q))
        super().__init__((M, 2), (K, 2))
        self._lipschitz = float(_math.sqrt(M * K))
        self.kernel_path = self._blocks[0].kernel_path
        self._name = (f"ShardedNUFFT3[d={d}, {self._n}x{self._axis}, "
                      f"Q={Q}, nf={nf}]")

    def stats(self) -> dict:
        """Partition info."""
        return {
            "n_x_blocks": self._n,
            "n_z_blocks": self._Q,
            "x_block_pad": self._Mb,
            "z_block_pad": self._Kb,
            "n_fine": self._nf,
        }

    def _fw(self, a):
        """(B, M, 2) -> (B, K, 2); one all-reduce of the (B, Q Kb, 2)
        partial sums."""
        B = a.shape[0]
        a_ext = torch.cat([a, a.new_zeros((B, 1, 2))], dim=1)
        ab = a_ext.index_select(1, self._x_idx)              # (B, Mb, 2)
        f = torch.cat([blk.apply(ab) for blk in self._blocks], dim=1)
        dist.all_reduce(f, group=self._group)
        out = a.new_zeros((B, self._K + 1, 2))
        out[:, self._z_idx] = f
        return out[:, : self._K]

    def _bw(self, f):
        """(B, K, 2) -> (B, M, 2): this rank's block, then one all-reduce
        of the rows it fills."""
        B = f.shape[0]
        f_ext = torch.cat([f, f.new_zeros((B, 1, 2))], dim=1)
        fb = f_ext.index_select(1, self._z_idx).reshape(
            B, self._Q, self._Kb, 2)
        c = sum(blk.adjoint(fb[:, q]) for q, blk in enumerate(self._blocks))
        out = f.new_zeros((B, self._M + 1, 2))
        out[:, self._x_idx] = c
        out = out[:, : self._M].contiguous()
        dist.all_reduce(out, group=self._group)
        return out

    def apply(self, arr):
        a = to_full(arr).to(self._x_idx.device)
        return self._replicated(
            self._map_batched(self._fw, a, 2, self.codim_shape))

    def adjoint(self, arr):
        f = to_full(arr).to(self._x_idx.device)
        return self._replicated(
            self._map_batched(self._bw, f, 2, self.dim_shape))

    def _expr(self):
        return (self._name,)
