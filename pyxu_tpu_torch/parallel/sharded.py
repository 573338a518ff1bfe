"""Sharding wrappers for operators, and block-sharded evaluation
(counterpart of ``pyxu_tpu/parallel/sharded.py``).

The JAX package leaves the partitioning of a wrapped operator to XLA's
GSPMD.  PyTorch has none, and ``DTensor``'s op propagation does not reach
the port's hand-written kernels, so :func:`with_sharding` gathers its input
into the global array the wrapped operator takes, runs it, and places the
output by ``out_spec``: the same numbers as the unwrapped operator.
:func:`sharded_block_diag` is the form that needs no gather: each rank
evaluates only its own blocks.
"""

from __future__ import annotations

import functools

import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from pyxu_tpu_torch.abc.operator import Operator, infer_operator_class
from pyxu_tpu_torch.operator.blocks import block_diag
from pyxu_tpu_torch.parallel.mesh import (axis_index, chunk_bounds,
                                          from_local, place, placements,
                                          to_full, to_local)

__all__ = ["with_sharding", "sharded_block_diag"]


class _ShardedMixin:
    """``op`` with its input gathered and its output placed by a
    PartitionSpec.  Composed with the operator class matching the wrapped
    op's properties, so that a nonlinear op is not claimed LINEAR and a
    proximable or differentiable one keeps ``prox`` and ``grad``.

    Memory: every rank holds the whole input and the whole output while
    the wrapped operator runs (a sharded input is all-gathered first), so
    a rank's peak is the unsharded operator's, not a shard's.
    """

    def __init__(self, op: Operator, mesh, in_spec, out_spec):
        Operator.__init__(self, op.dim_shape, op.codim_shape)
        self._op = op
        self._mesh = mesh
        self._in_spec = in_spec
        self._out_spec = out_spec
        self._lipschitz = op._lipschitz
        self._diff_lipschitz = op._diff_lipschitz
        self._name = f"Sharded[{op.name}]"

    def _placed(self, out, spec, core_rank):
        b = out.ndim - core_rank
        return place(out, self._mesh, placements(
            self._mesh, (None,) * b + tuple(spec), out.ndim))

    def apply(self, arr):
        out = self._op.apply(to_full(arr))
        return self._placed(out, self._out_spec, self.codim_rank)

    def adjoint(self, arr):
        out = self._op.adjoint(to_full(arr))
        return self._placed(out, self._in_spec, self.dim_rank)

    def grad(self, arr):
        out = self._op.grad(to_full(arr))
        return self._placed(out, self._in_spec, self.dim_rank)

    def prox(self, arr, tau):
        out = self._op.prox(to_full(arr), tau)
        return self._placed(out, self._in_spec, self.dim_rank)

    def estimate_lipschitz(self, **kw):
        L = self._op.estimate_lipschitz(**kw)
        self._lipschitz = L
        return L

    def estimate_diff_lipschitz(self, **kw):
        dL = self._op.estimate_diff_lipschitz(**kw)
        self._diff_lipschitz = dL
        return dL

    def _expr(self):
        return (f"sharded[{self._in_spec}->{self._out_spec}]", self._op)


def with_sharding(op: Operator, mesh, in_spec, out_spec=None) -> Operator:
    """Annotate an operator with input/output PartitionSpecs.

    ``in_spec``/``out_spec`` are sequences over the operator's dim/codim
    axes (mesh-axis names or None).  ``out_spec=None`` re-uses ``in_spec``
    when the ranks match, else replicates.  Inputs may be ``DTensor``s or
    plain tensors (the global array); outputs are ``DTensor``s.
    """
    in_spec = tuple(in_spec)
    if out_spec is None:
        out_spec = in_spec if len(in_spec) == op.codim_rank \
            else (None,) * op.codim_rank
    base = infer_operator_class(op.properties())
    return _sharded_class(_ShardedMixin, base)(op, mesh, in_spec,
                                               tuple(out_spec))


@functools.cache
def _sharded_class(mixin: type, base: type) -> type:
    return type(f"Sharded[{base.__name__}]", (mixin, base), {})


class _BlockShardedMixin:
    """``block_diag(ops)`` with the block axis cut over one mesh axis: each
    rank evaluates ``block_diag`` of its own blocks (``torch.chunk``'s cut)
    on its own part of the input, with no communication.  A functional's
    value is the sum over the blocks: one all-reduce of the per-rank sums,
    replicated."""

    def __init__(self, full, ops, mesh, mesh_axis):
        Operator.__init__(self, full.dim_shape, full.codim_shape)
        self._mesh = mesh
        self._ax = axis_index(mesh, mesh_axis)
        lo, hi = chunk_bounds(len(ops), mesh.size(self._ax),
                              mesh.get_local_rank(self._ax))
        self._local = block_diag(ops[lo:hi]) if hi > lo else None
        self._lipschitz = full._lipschitz
        self._diff_lipschitz = full._diff_lipschitz
        self._name = f"ShardedBlockDiag[{full.name}]"
        self._full = full

    def _plc(self, ndim: int, core_rank: int) -> tuple:
        """Shard the block axis (the first core axis) on the mesh axis."""
        plc = [Replicate()] * self._mesh.ndim
        plc[self._ax] = Shard(ndim - core_rank)
        return tuple(plc)

    def _run(self, method, arr, in_rank, out_core, *args):
        loc = to_local(arr, self._mesh, self._plc(arr.ndim, in_rank))
        batch = tuple(loc.shape[: loc.ndim - in_rank])
        if self._local is not None:
            out = getattr(self._local, method)(loc, *args)
        else:           # a rank with no blocks
            out = loc.new_zeros(batch + (0,) + tuple(out_core[1:]))
        shape = batch + tuple(out_core)
        return from_local(out.contiguous(), self._mesh,
                          self._plc(len(shape), len(out_core)), shape)

    def apply(self, arr):
        if self.codim_rank:
            return self._run("apply", arr, self.dim_rank, self.codim_shape)
        loc = to_local(arr, self._mesh, self._plc(arr.ndim, self.dim_rank))
        if self._local is not None:
            val = self._local.apply(loc).contiguous()
        else:
            val = loc.new_zeros(loc.shape[: loc.ndim - self.dim_rank])
        dist.all_reduce(val, group=self._mesh.get_group(self._ax))
        return place(val, self._mesh, (Replicate(),) * self._mesh.ndim)

    def adjoint(self, arr):
        return self._run("adjoint", arr, self.codim_rank, self.dim_shape)

    def prox(self, arr, tau):
        return self._run("prox", arr, self.dim_rank, self.dim_shape, tau)

    def grad(self, arr):
        return self._run("grad", arr, self.dim_rank, self.dim_shape)

    def _expr(self):
        return ("sharded_block_diag", self._full)


def sharded_block_diag(ops, mesh, mesh_axis: str = None) -> Operator:
    """``block_diag`` with the block axis sharded over a mesh axis: each
    rank evaluates its blocks locally (the counterpart of
    ``coo_block(..., parallel=True)``).  Rank-reducing blocks and
    functionals (a separable sum, whose value is replicated) are kept."""
    ops = list(ops)
    full = block_diag(ops)
    base = infer_operator_class(full.properties())
    return _sharded_class(_BlockShardedMixin, base)(full, ops, mesh,
                                                    mesh_axis)
