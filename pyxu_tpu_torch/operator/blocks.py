"""Block operators (counterpart of ``pyxu_tpu/operator/blocks.py``):
``stack``, ``vstack``, ``hstack``, ``block_diag``, ``block`` and
``coo_block``.

Each block is applied on its own, in a loop over the members: a member may
launch a hand-written kernel, and ``torch.func.vmap`` cannot pass through
the kernel wrappers, so there is no batched fast path over a homogeneous
family (the JAX package's vmapped path is an XLA layout choice).
``block_diag`` of functionals is a separable sum whose class comes from the
intersection of the members' properties, without QUADRATIC.
"""

from __future__ import annotations

import functools
import math as _math
from functools import reduce
from operator import add

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import (
    LinOp,
    Operator,
    Property,
    infer_operator_class,
)

__all__ = ["stack", "vstack", "hstack", "block_diag", "block", "coo_block"]


def _root_sum_square(ops) -> float:
    return _math.sqrt(sum(o.lipschitz ** 2 for o in ops))


class _Stack(LinOp):
    """Members of one dim and codim; the codim gains a leading axis of
    size N."""

    def __init__(self, ops):
        d0, c0 = ops[0].dim_shape, ops[0].codim_shape
        if not all(o.dim_shape == d0 and o.codim_shape == c0 for o in ops):
            raise ValueError("stack: the members' shapes differ")
        super().__init__(d0, (len(ops),) + tuple(c0))
        self._ops = tuple(ops)
        self._lipschitz = _root_sum_square(ops)
        self._name = "Stack"

    def apply(self, arr):
        return torch.stack([o.apply(arr) for o in self._ops],
                           dim=arr.ndim - self.dim_rank)

    def adjoint(self, arr):
        ax = arr.ndim - self.codim_rank
        return reduce(add, (o.adjoint(arr.select(ax, i))
                            for i, o in enumerate(self._ops)))

    def _expr(self):
        return ("stack", *self._ops)


def stack(ops):
    """Stack same-shape operators along a new leading codim axis."""
    return _Stack(list(ops))


class _VStack(LinOp):
    """The members' codomains concatenated along axis 0."""

    def __init__(self, ops):
        d0 = ops[0].dim_shape
        tail = ops[0].codim_shape[1:]
        if not all(o.dim_shape == d0 and o.codim_shape[1:] == tail
                   for o in ops):
            raise ValueError("vstack: the members' shapes differ")
        sizes = [o.codim_shape[0] for o in ops]
        super().__init__(d0, (sum(sizes),) + tuple(tail))
        self._ops = tuple(ops)
        self._sizes = sizes
        self._lipschitz = _root_sum_square(ops)
        self._name = "VStack"

    def apply(self, arr):
        return torch.cat([o.apply(arr) for o in self._ops],
                         dim=arr.ndim - self.dim_rank)

    def adjoint(self, arr):
        pieces = arr.split(self._sizes, dim=arr.ndim - self.codim_rank)
        return reduce(add, (o.adjoint(p) for o, p in zip(self._ops, pieces)))

    def _expr(self):
        return ("vstack", *self._ops)


def vstack(ops):
    """Concatenate the codomains along their leading axis."""
    return _VStack(list(ops))


class _HStack(LinOp):
    """The members' domains concatenated along axis 0."""

    def __init__(self, ops):
        c0 = ops[0].codim_shape
        tail = ops[0].dim_shape[1:]
        if not all(o.codim_shape == c0 and o.dim_shape[1:] == tail
                   for o in ops):
            raise ValueError("hstack: the members' shapes differ")
        sizes = [o.dim_shape[0] for o in ops]
        super().__init__((sum(sizes),) + tuple(tail), c0)
        self._ops = tuple(ops)
        self._sizes = sizes
        self._lipschitz = _root_sum_square(ops)
        self._name = "HStack"

    def apply(self, arr):
        pieces = arr.split(self._sizes, dim=arr.ndim - self.dim_rank)
        return reduce(add, (o.apply(p) for o, p in zip(self._ops, pieces)))

    def adjoint(self, arr):
        return torch.cat([o.adjoint(arr) for o in self._ops],
                         dim=arr.ndim - self.codim_rank)

    def _expr(self):
        return ("hstack", *self._ops)


def hstack(ops):
    """Concatenate the domains along their leading axis."""
    return _HStack(list(ops))


class _BlockDiag(LinOp):
    """dim ``(N, *d)``, codim ``(N, *c)``: member i acts on slice i."""

    def __init__(self, ops):
        d0, c0 = ops[0].dim_shape, ops[0].codim_shape
        if not all(o.dim_shape == d0 and o.codim_shape == c0 for o in ops):
            raise ValueError("block_diag: the members' shapes differ")
        super().__init__((len(ops),) + tuple(d0), (len(ops),) + tuple(c0))
        self._ops = tuple(ops)
        self._lipschitz = max(o.lipschitz for o in ops)
        self._name = "BlockDiag"

    def _each(self, arr, mode: str, in_rank: int):
        ax = arr.ndim - in_rank
        return torch.stack([getattr(o, mode)(arr.select(ax, i))
                            for i, o in enumerate(self._ops)], dim=ax)

    def apply(self, arr):
        return self._each(arr, "apply", self.dim_rank)

    def adjoint(self, arr):
        return self._each(arr, "adjoint", self.codim_rank)

    def _expr(self):
        return ("block_diag", *self._ops)


class _SeparableSumMixin:
    """F(x) = sum_i f_i(x[i]) over the leading axis; ``prox`` and ``grad``
    are per slice (the class only has them where every member does)."""

    def _init_sum(self, funcs):
        d0 = funcs[0].dim_shape
        if not all(f.dim_shape == d0 for f in funcs):
            raise ValueError("block_diag: the members' shapes differ")
        Operator.__init__(self, (len(funcs),) + tuple(d0), ())
        self._funcs = tuple(funcs)
        self._name = "SeparableSum"

    def _slices(self, arr):
        ax = arr.ndim - self.dim_rank
        return ax, [arr.select(ax, i) for i in range(len(self._funcs))]

    def apply(self, arr):
        _, xs = self._slices(arr)
        return reduce(add, (f.apply(x) for f, x in zip(self._funcs, xs)))

    def prox(self, arr, tau):
        ax, xs = self._slices(arr)
        return torch.stack([f.prox(x, tau) for f, x in zip(self._funcs, xs)],
                           dim=ax)

    def grad(self, arr):
        ax, xs = self._slices(arr)
        return torch.stack([f.grad(x) for f, x in zip(self._funcs, xs)],
                           dim=ax)

    def _expr(self):
        return ("separable_sum", *self._funcs)


@functools.cache
def _separable_sum_class(base: type) -> type:
    return type(f"SeparableSum[{base.__name__}]",
                (_SeparableSumMixin, base), {})


def _separable_sum(funcs):
    common = frozenset.intersection(*[f.properties() for f in funcs])
    # QUADRATIC would need a block-diagonal quadratic spec: drop it
    base = infer_operator_class(common - {Property.QUADRATIC})
    op = object.__new__(_separable_sum_class(base))
    op._init_sum(funcs)
    return op


def block_diag(ops):
    """Block-diagonal operator over the leading axis; a separable sum when
    every member is a functional."""
    ops = list(ops)
    if all(op.has(Property.FUNCTIONAL) for op in ops):
        return _separable_sum(ops)
    return _BlockDiag(ops)


class _COOBlock(LinOp):
    """A sparse grid of blocks on flattened segments: dim and codim are
    1-D, block (i, j) maps input segment j to output segment i, and the
    blocks of a row add up."""

    def __init__(self, blocks, grid_shape):
        R, C = grid_shape
        row_sizes, col_sizes = [None] * R, [None] * C
        for (i, j), op in blocks.items():
            cs, ds = op.codim_size, op.dim_size
            if row_sizes[i] not in (None, cs):
                raise ValueError(f"row {i}: the block sizes differ")
            if col_sizes[j] not in (None, ds):
                raise ValueError(f"column {j}: the block sizes differ")
            row_sizes[i], col_sizes[j] = cs, ds
        if any(s is None for s in row_sizes + col_sizes):
            raise ValueError("an empty block row or column")
        super().__init__((int(np.sum(col_sizes)),),
                         (int(np.sum(row_sizes)),))
        self._keys = tuple(sorted(blocks))
        self._ops = tuple(blocks[k] for k in self._keys)
        self._row_off = np.concatenate([[0], np.cumsum(row_sizes)]).tolist()
        self._col_off = np.concatenate([[0], np.cumsum(col_sizes)]).tolist()
        self._grid = (R, C)
        self._lipschitz = _root_sum_square(self._ops)
        self._name = "COOBlock"

    def _run(self, arr, mode, in_off, n_out, in_of, out_of):
        batch = arr.shape[:-1]
        acc = [None] * n_out
        for key, op in zip(self._keys, self._ops):
            i_in, i_out = key[in_of], key[out_of]
            in_shape, out_size = ((op.dim_shape, op.codim_size)
                                  if mode == "apply"
                                  else (op.codim_shape, op.dim_size))
            seg = arr[..., in_off[i_in]:in_off[i_in] + _math.prod(in_shape)]
            y = getattr(op, mode)(seg.reshape(batch + tuple(in_shape)))
            y = y.reshape(batch + (out_size,))
            acc[i_out] = y if acc[i_out] is None else acc[i_out] + y
        return torch.cat(acc, dim=-1)

    def apply(self, arr):
        return self._run(arr, "apply", self._col_off, self._grid[0], 1, 0)

    def adjoint(self, arr):
        return self._run(arr, "adjoint", self._row_off, self._grid[1], 0, 1)

    def _expr(self):
        return (f"coo_block[grid={self._grid}]", *self._ops)


def coo_block(spec, grid_shape):
    """``spec``: a dict ``{(i, j): op}`` on a ``grid_shape`` grid."""
    return _COOBlock(dict(spec), tuple(grid_shape))


def block(grid):
    """A dense 2-D grid (a list of rows) of blocks; ``None`` is an empty
    block."""
    blocks = {(i, j): op for i, row in enumerate(grid)
              for j, op in enumerate(row) if op is not None}
    return _COOBlock(blocks, (len(grid), max(len(r) for r in grid)))
