"""Derivative operators (counterpart of ``pyxu_tpu/operator/linop/diff.py``):
partial derivatives, gradient, Jacobian, divergence, Hessian, Laplacian and
the directional variants.

Finite-difference taps are solved on the host in float64 (Vandermonde
system), Gaussian-derivative taps come from the Hermite recurrence, and
every partial derivative is a separable :class:`Stencil`: in 2-D, in
``constant`` or ``symmetric`` mode, it runs on the hand-written stencil
kernel (``kernel_path == "kernel"``).  Stacks are thin LinOps whose apply
stacks the partials' outputs and whose adjoint sums their adjoints.

Direction fields (constant ``(D,)`` or per pixel ``(D, *dim_shape)``) are
normalised to unit vectors and are not differentiated: they weight the
partials pointwise.  A host array goes to ``device`` (resolved as every
entry point resolves it), a tensor keeps its device; the weights are
applied in the input's dtype.
"""

from __future__ import annotations

import math as _math
from functools import reduce
from operator import add

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp, SquareOp
from pyxu_tpu_torch.operator.linop.stencil import Stencil
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = [
    "PartialDerivative",
    "Gradient",
    "Jacobian",
    "Divergence",
    "Hessian",
    "Laplacian",
    "DirectionalDerivative",
    "DirectionalGradient",
    "DirectionalLaplacian",
    "DirectionalHessian",
]


# ------------------------------------------------------------------- taps ---

def _fd_coeffs(deriv: int, scheme: str = "forward", accuracy: int = 1):
    """Offsets and coefficients of the finite difference for
    d^deriv/dx^deriv: solves sum_j c_j o_j^k = k! delta_{k,deriv}."""
    if deriv == 0:
        return np.array([0]), np.array([1.0])
    if scheme == "central":
        acc = accuracy + (accuracy % 2)
        half = (deriv + 1) // 2 - 1 + acc // 2
        offsets = np.arange(-half, half + 1)
    elif scheme == "forward":
        offsets = np.arange(0, deriv + accuracy)
    elif scheme == "backward":
        offsets = np.arange(-(deriv + accuracy) + 1, 1)
    else:
        raise ValueError(
            f"scheme {scheme!r} not in ('central','forward','backward')")
    n = len(offsets)
    V = np.vander(offsets.astype(np.float64), n, increasing=True).T
    rhs = np.zeros(n)
    rhs[deriv] = _math.factorial(deriv)
    coeffs = np.linalg.solve(V, rhs)
    coeffs[np.abs(coeffs) < 1e-12] = 0.0
    return offsets, coeffs


def _gauss_deriv_kernel(deriv: int, sigma: float, truncate: float = 3.0):
    """Offsets and taps of the order-``deriv`` Gaussian derivative, by the
    Hermite recurrence p_{n+1} = p_n' - (x / sigma^2) p_n on
    g(x) = exp(-x^2 / 2 sigma^2).  The taps are flipped: a Stencil
    correlates, and the derivative is a convolution kernel."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    p = np.polynomial.Polynomial([1.0])
    dgauss = np.polynomial.Polynomial([0.0, -1.0 / sigma ** 2])
    for _ in range(deriv):
        p = p.deriv() + p * dgauss
    return x.astype(np.int64), (p(x) * g)[::-1]


def _per_axis(v, rank: int) -> tuple:
    if isinstance(v, (list, tuple)):
        if len(v) != rank:
            raise ValueError(f"{v}: want one value per axis ({rank})")
        return tuple(v)
    return (v,) * rank


def _canon_order(order, rank: int) -> tuple:
    order = (int(order),) if np.isscalar(order) else tuple(map(int, order))
    if len(order) != rank or any(o < 0 for o in order):
        raise ValueError(f"order {order} for a rank-{rank} operator")
    return order


def _build_pd(dim_shape, order, taps, mode, sampling):
    """The separable Stencil of per-axis ``taps`` (offsets, coefficients),
    the sampling scale folded into the first axis's taps."""
    sampling = _per_axis(sampling, len(dim_shape))
    kernels, centers, scale = [], [], 1.0
    for ax, ((offsets, coeffs), o) in enumerate(zip(taps, order)):
        kernels.append(np.asarray(coeffs))
        centers.append(int(-offsets[0]))
        scale /= float(sampling[ax]) ** o
    kernels[0] = kernels[0] * scale
    if len(dim_shape) == 1:
        op = Stencil(dim_shape, kernels[0], centers[0], mode=mode)
    else:
        op = Stencil(dim_shape, kernels, centers, mode=mode)
    op._name = f"PartialDerivative[{order}]"
    return op


class PartialDerivative:
    """Factory namespace.  ``order`` is a per-axis tuple of derivative
    orders; the result is a separable :class:`Stencil` scaled by the grid
    sampling."""

    @staticmethod
    def finite_difference(dim_shape, order, scheme="forward", accuracy=1,
                          mode="constant", sampling=1.0):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        order = _canon_order(order, rank)
        schemes = _per_axis(scheme, rank)
        accs = _per_axis(accuracy, rank)
        taps = [_fd_coeffs(o, schemes[ax], accs[ax])
                for ax, o in enumerate(order)]
        return _build_pd(dim_shape, order, taps, mode, sampling)

    @staticmethod
    def gaussian_derivative(dim_shape, order, sigma=1.0, truncate=3.0,
                            mode="constant", sampling=1.0):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        order = _canon_order(order, rank)
        sigmas = _per_axis(sigma, rank)
        truncs = _per_axis(truncate, rank)
        taps = [_gauss_deriv_kernel(o, sigmas[ax], truncs[ax]) if o > 0
                else (np.array([0]), np.array([1.0]))
                for ax, o in enumerate(order)]
        return _build_pd(dim_shape, order, taps, mode, sampling)


def _pd_factory(diff_method: str, dim_shape, order, mode, sampling,
                **diff_kwargs):
    if diff_method == "fd":
        return PartialDerivative.finite_difference(
            dim_shape, order, scheme=diff_kwargs.get("scheme", "forward"),
            accuracy=diff_kwargs.get("accuracy", 1), mode=mode,
            sampling=sampling)
    if diff_method == "gd":
        return PartialDerivative.gaussian_derivative(
            dim_shape, order, sigma=diff_kwargs.get("sigma", 1.0),
            truncate=diff_kwargs.get("truncate", 3.0), mode=mode,
            sampling=sampling)
    raise ValueError(f"diff_method {diff_method!r} not in ('fd','gd')")


def _one_hot(rank, ax, value=1):
    o = [0] * rank
    o[ax] = value
    return tuple(o)


def _second_order_kwargs(diff_method, diff_kwargs) -> dict:
    """Second-order and directional partials default to central accuracy
    2 finite differences."""
    kw = dict(diff_kwargs)
    if diff_method == "fd":
        kw.setdefault("scheme", "central")
        kw.setdefault("accuracy", 2)
    return kw


# ------------------------------------------------------------ stacked ops ---

class _StackedDiff(LinOp):
    """codim = (n_ops, *dim_shape): apply stacks the child outputs, adjoint
    sums the child adjoints."""

    def __init__(self, ops, name: str):
        dim_shape = ops[0].dim_shape
        super().__init__(dim_shape, (len(ops),) + tuple(dim_shape))
        self._ops = tuple(ops)
        self._lipschitz = _math.sqrt(sum(o.lipschitz ** 2 for o in ops))
        self._name = name

    def apply(self, arr):
        return torch.stack([op.apply(arr) for op in self._ops],
                           dim=arr.ndim - self.dim_rank)

    def adjoint(self, arr):
        ax = arr.ndim - self.codim_rank
        return reduce(add, (op.adjoint(arr.select(ax, i))
                            for i, op in enumerate(self._ops)))

    def _expr(self):
        return (self._name, *self._ops)


def Gradient(dim_shape, directions=None, diff_method="fd", mode="constant",
             sampling=1.0, **diff_kwargs):
    """Stack of first-order partials; codim ``(D, *dim_shape)``.
    ``diff_method`` ``"fd"`` (``scheme``, ``accuracy``; forward, 1 by
    default) or ``"gd"`` (``sigma``, ``truncate``)."""
    dim_shape = as_canonical_shape(dim_shape)
    rank = len(dim_shape)
    directions = tuple(range(rank)) if directions is None else \
        tuple(directions)
    ops = [_pd_factory(diff_method, dim_shape, _one_hot(rank, ax), mode,
                       sampling, **diff_kwargs) for ax in directions]
    return _StackedDiff(ops, "Gradient")


class Jacobian(LinOp):
    """The gradient of each channel of a vector field: ``(C, *sp) -> (C, D,
    *sp)``; the channel axis rides as a batch axis of the gradient."""

    def __init__(self, dim_shape, directions=None, diff_method="fd",
                 mode="constant", sampling=1.0, **diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        C, spatial = dim_shape[0], dim_shape[1:]
        grad = Gradient(spatial, directions=directions,
                        diff_method=diff_method, mode=mode,
                        sampling=sampling, **diff_kwargs)
        super().__init__(dim_shape, (C,) + tuple(grad.codim_shape))
        self._grad = grad
        self._lipschitz = grad.lipschitz
        self._name = "Jacobian"

    def apply(self, arr):
        return self._grad.apply(arr)

    def adjoint(self, arr):
        return self._grad.adjoint(arr)

    def _expr(self):
        return ("Jacobian", self._grad)


class Divergence(LinOp):
    """div(v) = sum_i D_i v_i: ``(D, *sp) -> sp``.  With finite differences
    the scheme is flipped (forward <-> backward), so that the divergence of
    a forward gradient is the centred Laplacian."""

    def __init__(self, dim_shape, directions=None, diff_method="fd",
                 mode="constant", sampling=1.0, **diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        D, spatial = dim_shape[0], dim_shape[1:]
        rank = len(spatial)
        directions = tuple(range(rank)) if directions is None else \
            tuple(directions)
        if len(directions) != D:
            raise ValueError("the leading axis must match the directions")
        kw = dict(diff_kwargs)
        if diff_method == "fd":
            scheme = kw.get("scheme", "forward")
            kw["scheme"] = {"forward": "backward",
                            "backward": "forward"}.get(scheme, scheme)
        self._ops = tuple(_pd_factory(diff_method, spatial,
                                      _one_hot(rank, ax), mode, sampling,
                                      **kw) for ax in directions)
        super().__init__(dim_shape, spatial)
        self._lipschitz = _math.sqrt(sum(o.lipschitz ** 2
                                         for o in self._ops))
        self._name = "Divergence"

    def apply(self, arr):
        ax = arr.ndim - self.dim_rank
        return reduce(add, (op.apply(arr.select(ax, i))
                            for i, op in enumerate(self._ops)))

    def adjoint(self, arr):
        return torch.stack([op.adjoint(arr) for op in self._ops],
                           dim=arr.ndim - (self.dim_rank - 1))

    def _expr(self):
        return ("Divergence", *self._ops)


def Hessian(dim_shape, directions=None, diff_method="fd", mode="constant",
            sampling=1.0, **diff_kwargs):
    """Second-order partials; codim ``(n, *dim_shape)``.  ``directions``:
    ``None`` or ``"all"`` (the D(D+1)/2 unique pairs i <= j), one pair
    ``(i, j)``, or a list of pairs.  Central accuracy 2 by default."""
    dim_shape = as_canonical_shape(dim_shape)
    rank = len(dim_shape)
    if directions is None or (isinstance(directions, str)
                              and directions == "all"):
        directions = [(i, j) for i in range(rank) for j in range(i, rank)]
    elif (len(directions) == 2
          and all(isinstance(d, (int, np.integer)) for d in directions)):
        directions = [tuple(directions)]
    kw = _second_order_kwargs(diff_method, diff_kwargs)
    ops = []
    for (i, j) in directions:
        o = [0] * rank
        o[i] += 1
        o[j] += 1
        ops.append(_pd_factory(diff_method, dim_shape, tuple(o), mode,
                               sampling, **kw))
    return _StackedDiff(ops, "Hessian")


class Laplacian(SquareOp):
    """sum_i d^2/dx_i^2 over ``directions`` (every axis by default)."""

    def __init__(self, dim_shape, directions=None, diff_method="fd",
                 mode="constant", sampling=1.0, **diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        directions = tuple(range(rank)) if directions is None else \
            tuple(directions)
        kw = _second_order_kwargs(diff_method, diff_kwargs)
        self._ops = tuple(_pd_factory(diff_method, dim_shape,
                                      _one_hot(rank, ax, 2), mode, sampling,
                                      **kw) for ax in directions)
        super().__init__(dim_shape)
        self._lipschitz = sum(o.lipschitz for o in self._ops)
        self._name = "Laplacian"

    def apply(self, arr):
        return reduce(add, (op.apply(arr) for op in self._ops))
                            
    def adjoint(self, arr):
        return reduce(add, (op.adjoint(arr) for op in self._ops))
                            
    def _expr(self):
        return ("Laplacian", *self._ops)


# -------------------------------------------------------- directional ops ---

def _canon_dirs(directions, dim_shape, device=None) -> torch.Tensor:
    """A constant ``(D,)`` or per-pixel ``(D, *dim_shape)`` direction field
    as a tensor of unit vectors.  A host array is normalised in its own
    floating dtype (integers in float64) and goes to ``device``."""
    if isinstance(directions, torch.Tensor):
        v = directions if device is None else directions.to(device)
        if not v.is_floating_point():
            v = v.to(torch.float64)
    else:
        a = np.asarray(directions)
        if not np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float64)
        v = torch.from_numpy(np.ascontiguousarray(a)).to(
            resolve_device(device))
    rank = len(dim_shape)
    if v.ndim > 1 and tuple(v.shape[1:]) != tuple(dim_shape):
        raise ValueError(f"direction field {tuple(v.shape)} for a "
                         f"{tuple(dim_shape)} domain")
    if v.shape[0] != rank:
        raise ValueError(f"{v.shape[0]} direction components for rank "
                         f"{rank}")
    return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)


def _hessian_partials(dim_shape, diff_method, mode, sampling, diff_kwargs):
    """The D(D+1)/2 unique second-order partials, in (i <= j) order."""
    rank = len(dim_shape)
    kw = _second_order_kwargs(diff_method, diff_kwargs)
    pairs = [(i, j) for i in range(rank) for j in range(i, rank)]
    ops = []
    for (i, j) in pairs:
        o = [0] * rank
        o[i] += 1
        o[j] += 1
        ops.append(_pd_factory(diff_method, dim_shape, tuple(o), mode,
                               sampling, **kw))
    return pairs, tuple(ops)


class _SecondDirDeriv(LinOp):
    """v1^T H v2: the upper-triangular partials weighted pointwise by the
    outer product of the two fields (off-diagonal weights x2)."""

    def __init__(self, dim_shape, v1, v2, diff_method, mode, sampling,
                 diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        pairs, ops = _hessian_partials(dim_shape, diff_method, mode,
                                       sampling, diff_kwargs)
        self._ops = ops
        self._w = tuple((1.0 if i == j else 2.0) * v1[i] * v2[j]
                        for (i, j) in pairs)
        super().__init__(dim_shape, dim_shape)
        wmax = [float(torch.max(torch.abs(w))) for w in self._w]
        self._lipschitz = sum(m * o.lipschitz for m, o in zip(wmax, ops))
        self._name = "SecondDirectionalDerivative"

    def apply(self, arr):
        return reduce(add, (w.to(arr.dtype) * op.apply(arr)
                            for w, op in zip(self._w, self._ops)))

    def adjoint(self, arr):
        return reduce(add, (op.adjoint(w.to(arr.dtype) * arr)
                            for w, op in zip(self._w, self._ops)))

    def _expr(self):
        return ("SecondDirectionalDerivative", *self._ops)


class _FirstDirDeriv(LinOp):
    """D_v x = sum_i v_i (D_i x), v a constant or per-pixel unit field."""

    def __init__(self, dim_shape, directions, diff_method, mode, sampling,
                 diff_kwargs, device=None):
        dim_shape = as_canonical_shape(dim_shape)
        rank = len(dim_shape)
        self._v = _canon_dirs(directions, dim_shape, device)
        kw = _second_order_kwargs(diff_method, diff_kwargs)
        self._ops = tuple(_pd_factory(diff_method, dim_shape,
                                      _one_hot(rank, ax), mode, sampling,
                                      **kw) for ax in range(rank))
        super().__init__(dim_shape, dim_shape)
        # unit directions: |v| = 1 pointwise
        self._lipschitz = _math.sqrt(sum(o.lipschitz ** 2
                                         for o in self._ops))
        self._name = "FirstDirectionalDerivative"

    def apply(self, arr):
        v = self._v.to(arr.dtype)
        return reduce(add, (v[i] * op.apply(arr)
                            for i, op in enumerate(self._ops)))

    def adjoint(self, arr):
        v = self._v.to(arr.dtype)
        return reduce(add, (op.adjoint(v[i] * arr)
                            for i, op in enumerate(self._ops)))

    def _expr(self):
        return ("FirstDirectionalDerivative", *self._ops)


def _is_pair(directions) -> bool:
    """Whether an order-2 ``directions`` is two direction fields of one
    shape (else it is one field, used on both sides)."""
    if not (isinstance(directions, (tuple, list)) and len(directions) == 2):
        return False
    a, b = (tuple(d.shape) if isinstance(d, torch.Tensor) else np.shape(d)
            for d in directions)
    return len(a) >= 1 and a == b


def DirectionalDerivative(dim_shape, order, directions=None,
                          diff_method: str = "fd", mode="constant",
                          sampling=1.0, device=None, **diff_kwargs):
    """Directional derivative of order 1 (sum_i v_i d/dx_i) or 2
    (v1^T H v2), the directions normalised to unit vectors.
    ``DirectionalDerivative(shape, directions)`` (order omitted) is order
    1."""
    if directions is None:
        order, directions = 1, order
    if order not in (1, 2):
        raise ValueError("`order` should be either 1 or 2")
    dim_shape = as_canonical_shape(dim_shape)
    if order == 1:
        return _FirstDirDeriv(dim_shape, directions, diff_method, mode,
                              sampling, diff_kwargs, device)
    d1, d2 = directions if _is_pair(directions) else (directions,) * 2
    v1 = _canon_dirs(d1, dim_shape, device)
    v2 = _canon_dirs(d2, dim_shape, device)
    return _SecondDirDeriv(dim_shape, v1, v2, diff_method, mode, sampling,
                           diff_kwargs)


def DirectionalGradient(dim_shape, directions, diff_method: str = "fd",
                        mode="constant", sampling=1.0, device=None,
                        **diff_kwargs):
    """Stack of first directional derivatives, one a direction (field)."""
    dim_shape = as_canonical_shape(dim_shape)
    ops = [_FirstDirDeriv(dim_shape, d, diff_method, mode, sampling,
                          diff_kwargs, device) for d in directions]
    return _StackedDiff(ops, "DirectionalGradient")


class DirectionalLaplacian(SquareOp):
    """sum_d w_d v_d^T H v_d, the second-derivative form (not the
    divergence form sum D_v^T D_v, its negation for antisymmetric first
    differences)."""

    def __init__(self, dim_shape, directions, weights=None,
                 diff_method: str = "fd", mode="constant", sampling=1.0,
                 device=None, **diff_kwargs):
        dim_shape = as_canonical_shape(dim_shape)
        directions = list(directions)
        if weights is None:
            weights = [1.0] * len(directions)
        elif len(weights) != len(directions):
            raise ValueError(
                "The number of weights and directions provided differ.")
        self._weights = tuple(float(w) for w in weights)
        self._dds = tuple(
            _SecondDirDeriv(dim_shape, v, v, diff_method, mode, sampling,
                            diff_kwargs)
            for v in (_canon_dirs(d, dim_shape, device) for d in directions))
        super().__init__(dim_shape)
        self._lipschitz = sum(abs(w) * d.lipschitz
                              for w, d in zip(self._weights, self._dds))
        self._name = "DirectionalLaplacian"

    def apply(self, arr):
        return reduce(add, (w * dd.apply(arr)
                            for w, dd in zip(self._weights, self._dds)))

    def adjoint(self, arr):
        return reduce(add, (w * dd.adjoint(arr)
                            for w, dd in zip(self._weights, self._dds)))

    def _expr(self):
        return ("DirectionalLaplacian", *self._dds)


def DirectionalHessian(dim_shape, directions, diff_method: str = "fd",
                       mode="constant", sampling=1.0, device=None,
                       **diff_kwargs):
    """Stack of v_i^T H v_j, i <= j, over the given direction fields."""
    dim_shape = as_canonical_shape(dim_shape)
    vs = [_canon_dirs(d, dim_shape, device) for d in directions]
    ops = [_SecondDirDeriv(dim_shape, vs[i], vs[j], diff_method, mode,
                           sampling, diff_kwargs)
           for i in range(len(vs)) for j in range(i, len(vs))]
    return _StackedDiff(ops, "DirectionalHessian")
