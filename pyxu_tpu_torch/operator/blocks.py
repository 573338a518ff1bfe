"""Block operators (counterpart of ``pyxu_tpu/operator/blocks.py``):
``stack``, ``vstack``, ``hstack``, ``block_diag``, ``block`` and
``coo_block``.

A *homogeneous* family (:func:`_homogeneous`: the JAX package's verdict,
same class and non-tensor state, tensor state of equal shapes and dtypes,
at least one tensor) is evaluated as one batch at the JAX package's four
vmapped sites: ``stack``'s apply, ``block_diag``'s apply and adjoint, and
a separable sum's prox.  The rule is chosen once, at construction, from
the members' structure, and recorded in ``batched_path``:

* ``"vmap"``: ``torch.func.vmap`` over member 0 rebuilt with the members'
  stacked tensors (:func:`_stack_ops`), for families made of plain
  PyTorch operators (:func:`_vmappable`);
* ``"quadratic"``: a separable sum of QuadraticFunc members with one
  ``Q``: one CG over the stacked right-hand sides, each member stopping on its
  own residual (``math/cg.py``, ``members=True``), one host read a check
  for the whole family;
* ``"stencil"``: Stencil members on the kernel path: one launch of the
  stencil kernel, with the members as its batch (equal taps) or with a tap
  set a member (``ops/stencil.py`` ``separable_correlate2d_members``);
* ``"loop"``: every other family, one member after another (members that
  reach another hand-written kernel, or read the host).

A batched rule that raises, raises.  ``stack``'s adjoint, a separable
sum's apply and grad, and ``coo_block`` loop, as in the JAX package.
``block_diag`` of functionals is a separable sum whose class comes from
the intersection of the members' properties, without QUADRATIC.
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
    QuadraticFunc,
    infer_operator_class,
)
from pyxu_tpu_torch.ops import stencil as _st

__all__ = ["stack", "vstack", "hstack", "block_diag", "block", "coo_block"]


def _root_sum_square(ops) -> float:
    return _math.sqrt(sum(o.lipschitz ** 2 for o in ops))


# ------------------------------------------------------------- homogeneity --

# cached constants, never part of an operator's structure (the JAX
# package's _VOLATILE_FIELDS)
_VOLATILE = frozenset(("_lipschitz", "_diff_lipschitz", "_chan_cache"))
_LEAF = "<leaf>"


def _fields(op):
    """``(name, value, is_scalar_leaf)`` of an operator's structural state,
    by name: cached constants and the class's ``_batch_derived`` left out;
    the class's ``_batch_scalars`` that hold a Python number are leaves."""
    cls = type(op)
    skip = _VOLATILE.union(getattr(cls, "_batch_derived", ()))
    scalars = getattr(cls, "_batch_scalars", ())
    for k in sorted(vars(op)):
        if k not in skip:
            v = vars(op)[k]
            yield k, v, (k in scalars and isinstance(v, (int, float))
                         and not isinstance(v, bool))


def _walk(obj, leaves: list):
    """``obj``'s structure, its leaves appended to ``leaves``: tensors and
    host arrays are leaves; operators, tuples, lists and dicts are walked
    into; anything else is compared by value."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        leaves.append(obj)
        return _LEAF
    if isinstance(obj, Operator):
        items = []
        for k, v, scalar in _fields(obj):
            if scalar:
                leaves.append(v)
                items.append((k, _LEAF))
            else:
                items.append((k, _walk(v, leaves)))
        return (type(obj), tuple(items))
    if type(obj) in (tuple, list):
        return (type(obj), tuple(_walk(v, leaves) for v in obj))
    if type(obj) is dict:
        return (dict, tuple((k, _walk(obj[k], leaves))
                            for k in sorted(obj, key=repr)))
    return obj          # compared by value, as the JAX package's aux data


def _rebuild(obj, leaves):
    """A copy of ``obj`` with its leaves taken in turn from the iterator
    ``leaves`` (the order of :func:`_walk`)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return next(leaves)
    if isinstance(obj, Operator):
        new = object.__new__(type(obj))
        state = dict(vars(obj))
        for k, v, scalar in _fields(obj):
            state[k] = next(leaves) if scalar else _rebuild(v, leaves)
        new.__dict__.update(state)
        return new
    if type(obj) in (tuple, list):
        return type(obj)(_rebuild(v, leaves) for v in obj)
    if type(obj) is dict:
        return {k: _rebuild(obj[k], leaves) for k in sorted(obj, key=repr)}
    return obj


def _flatten(op):
    leaves = []
    return _walk(op, leaves), leaves


def _leaf_sig(v):
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return tuple(v.shape), v.dtype
    return (), None          # a Python number the JAX package holds as leaf


def _homogeneous(ops) -> bool:
    """True when the members share their structure and their leaves'
    shapes and dtypes, with at least one leaf (``pyxu_tpu/operator/
    blocks.py`` ``_homogeneous``)."""
    (t0, l0), *rest = [_flatten(op) for op in ops]
    sig0 = [_leaf_sig(v) for v in l0]
    return bool(l0) and all(t == t0 and [_leaf_sig(v) for v in ls] == sig0
                            for t, ls in rest)


def _stack_ops(ops) -> list:
    """The leaves of homogeneous ``ops`` stacked on a new leading axis (a
    Python number leaf as a tensor of the members' values, on the device
    and in the dtype of the first floating tensor leaf)."""
    per = [_flatten(op)[1] for op in ops]
    like = next((v for v in per[0] if isinstance(v, torch.Tensor)
                 and v.is_floating_point()), None)
    return [torch.stack(ls) if isinstance(ls[0], torch.Tensor)
            else torch.as_tensor(np.asarray(ls)).to(
                device=None if like is None else like.device,
                dtype=None if like is None else like.dtype)
            for ls in zip(*per)]


def _same(a, b) -> bool:
    """``a`` and ``b`` are one operator: the same object, or the same
    structure with equal leaves."""
    if a is b:
        return True
    (ta, la), (tb, lb) = _flatten(a), _flatten(b)
    if ta != tb or [_leaf_sig(v) for v in la] != [_leaf_sig(v) for v in lb]:
        return False
    for u, v in zip(la, lb):
        if isinstance(u, torch.Tensor):
            if not (u is v or torch.equal(u, v)):
                return False
        elif not np.array_equal(u, v):
            return False
    return True


@functools.cache
def _vmap_classes() -> tuple:
    """The operator classes whose methods are plain PyTorch code that
    ``torch.func.vmap`` passes through: no hand-written kernel, no host
    read."""
    from pyxu_tpu_torch.abc.arithmetic import (AddMixin, ArgScaleMixin,
                                               ArgShiftMixin, ScaleMixin)
    from pyxu_tpu_torch.operator.func.indicator import (HyperSlab, L2Ball,
                                                        LInfinityBall,
                                                        PositiveOrthant)
    from pyxu_tpu_torch.operator.func.norm import (L1Norm, L2Norm, L21Norm,
                                                   PositiveL1Norm,
                                                   SquaredL2Norm)
    from pyxu_tpu_torch.operator.linop.base import (DiagonalOp,
                                                    ExplicitLinFunc,
                                                    ExplicitLinOp,
                                                    HomothetyOp, IdentityOp,
                                                    NullFunc, NullOp)
    return (AddMixin, ArgScaleMixin, ArgShiftMixin, ScaleMixin, HyperSlab,
            L2Ball, LInfinityBall, PositiveOrthant, L1Norm, L2Norm, L21Norm,
            PositiveL1Norm, SquaredL2Norm, DiagonalOp, ExplicitLinFunc,
            ExplicitLinOp, HomothetyOp, IdentityOp, NullFunc, NullOp)


def _vmappable(op) -> bool:
    """Every operator in ``op``'s structure is of :func:`_vmap_classes`,
    and every leaf a tensor or a Python number."""
    ok = _vmap_classes()

    def walk(obj):
        if isinstance(obj, np.ndarray):
            return False
        if isinstance(obj, Operator):
            return isinstance(obj, ok) and all(
                walk(v) for _, v, _ in _fields(obj))
        if type(obj) in (tuple, list):
            return all(map(walk, obj))
        if type(obj) is dict:
            return all(map(walk, obj.values()))
        return True
    return walk(op)


def _quadratic_family(funcs) -> bool:
    """QuadraticFuncs with the CG prox, no preconditioner and one Q."""
    f0 = funcs[0]
    return (isinstance(f0, QuadraticFunc)
            and type(f0).prox is QuadraticFunc.prox
            and f0._prox_precond is None
            and all(_same(f._Q, f0._Q) for f in funcs[1:]))


def _stencil_family(ops) -> bool:
    from pyxu_tpu_torch.operator.linop.stencil import Stencil
    return isinstance(ops[0], Stencil) and ops[0].kernel_path == "kernel"


def _batched_path(ops, prox: bool = False) -> str:
    """The rule of a family (``prox``: a separable sum's), chosen from the
    members' structure alone."""
    if not _homogeneous(ops):
        return "loop"
    if prox and _quadratic_family(ops):
        return "quadratic"
    if not prox and _stencil_family(ops):
        return "stencil"
    return "vmap" if _vmappable(ops[0]) else "loop"


class _Family:
    """A ``"vmap"`` family: its members, and their leaves stacked once, at
    first use, and kept (the JAX package's ``_stack_ops`` cache, held by
    the block that owns the members rather than by a module-level
    cache)."""

    def __init__(self, ops):
        self.ops = ops
        self._leaves = None

    def __call__(self, method: str, *args, in_dims=(), out_dims=0):
        """``method`` of each member as one ``torch.func.vmap`` over member 0
        rebuilt with the stacked leaves; ``args`` batched along
        ``in_dims``."""
        if self._leaves is None:
            self._leaves = _stack_ops(self.ops)
        op0 = self.ops[0]

        def one(leaves, *a):
            return getattr(_rebuild(op0, iter(leaves)), method)(*a)
        return torch.func.vmap(one, in_dims=(0,) + tuple(in_dims),
                               out_dims=out_dims)(self._leaves, *args)


def _batched_members(path: str, ops):
    """What the rule ``path`` evaluates the members with, or None."""
    if path == "vmap":
        return _Family(ops)
    if path == "stencil":
        return _MemberStencils(ops)
    return None


class _MemberStencils:
    """A ``"stencil"`` family's launch data: the members' kernel taps, and
    whether they are all equal."""

    def __init__(self, ops):
        taps = [o._taps for o in ops]
        self.equal = all(t == taps[0] for t in taps)
        self.taps = _st.MemberTaps(taps)

    def apply(self, x, adjoint: bool = False, shared_input: bool = False):
        """x ``(..., N, H, W)`` (``shared_input``: ``(..., H, W)``) ->
        ``(..., N, H, W)``: equal taps on a block-diagonal batch are one
        single-tap-set launch over it."""
        x = x.contiguous()
        if self.equal and not shared_input:
            return _st.separable_correlate2d(x, self.taps.taps[0], adjoint)
        return _st.separable_correlate2d_members(x, self.taps, adjoint,
                                                 shared_input)


class _Stack(LinOp):
    """Members of one dim and codim; the codim gains a leading axis of
    size N."""

    def __init__(self, ops):
        d0, c0 = ops[0].dim_shape, ops[0].codim_shape
        if not all(o.dim_shape == d0 and o.codim_shape == c0 for o in ops):
            raise ValueError("stack: the members' shapes differ")
        super().__init__(d0, (len(ops),) + tuple(c0))
        self._ops = tuple(ops)
        self.batched_path = _batched_path(self._ops)
        self._members = _batched_members(self.batched_path, self._ops)
        self._lipschitz = _root_sum_square(ops)
        self._name = "Stack"

    def apply(self, arr):
        ax = arr.ndim - self.dim_rank
        if self.batched_path == "vmap":
            return self._members("apply", arr, in_dims=(None,), out_dims=ax)
        if self.batched_path == "stencil":
            return self._members.apply(arr, shared_input=True)
        return torch.stack([o.apply(arr) for o in self._ops], dim=ax)

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
        self.batched_path = _batched_path(self._ops)
        self._members = _batched_members(self.batched_path, self._ops)
        self._lipschitz = max(o.lipschitz for o in ops)
        self._name = "BlockDiag"

    def _each(self, arr, mode: str, in_rank: int):
        ax = arr.ndim - in_rank
        if self.batched_path == "vmap":
            return self._members(mode, arr, in_dims=(ax,), out_dims=ax)
        if self.batched_path == "stencil":
            return self._members.apply(arr, adjoint=mode == "adjoint")
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
        self.batched_path = _batched_path(self._funcs, prox=True)
        self._members = _batched_members(self.batched_path, self._funcs)
        self._name = "SeparableSum"

    def _slices(self, arr):
        ax = arr.ndim - self.dim_rank
        return ax, [arr.select(ax, i) for i in range(len(self._funcs))]

    def apply(self, arr):
        _, xs = self._slices(arr)
        return reduce(add, (f.apply(x) for f, x in zip(self._funcs, xs)))

    def prox(self, arr, tau):
        ax = arr.ndim - self.dim_rank
        if self.batched_path == "vmap":
            return self._members("prox", arr, tau, in_dims=(ax, None),
                                 out_dims=ax)
        if self.batched_path == "quadratic":
            return self._quadratic_prox(arr.movedim(ax, 0), tau).movedim(
                0, ax)
        _, xs = self._slices(arr)
        return torch.stack([f.prox(x, tau) for f, x in zip(self._funcs, xs)],
                           dim=ax)

    def _quadratic_prox(self, x, tau):
        """The members' ``(I + tau Q) p_i = x_i - tau c_i`` (``x``: the member
        axis first) as one CG, each member stopping on its own residual
        (``QuadraticFunc.prox`` under ``jax.vmap``)."""
        from pyxu_tpu_torch.math.cg import cg_solve
        f0 = self._funcs[0]
        tau = float(tau)
        rtol, maxiter = f0._prox_budget(x.dtype)
        cgrad = torch.stack([f._c.grad(xi) for f, xi in zip(self._funcs, x)])
        return cg_solve(lambda p: p + tau * f0._Q.apply(p), x - tau * cgrad,
                        x0=x, rtol=rtol, maxiter=maxiter, members=True)

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
