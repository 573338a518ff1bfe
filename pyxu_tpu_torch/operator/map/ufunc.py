"""Element-wise maps (counterpart of ``pyxu_tpu/operator/map/ufunc.py``).

One generic :class:`ElementWiseMap` parameterised by ``(fn, dfn, L, dL)``:
``fn`` is a torch element-wise function, ``dfn`` its derivative (``None``:
``torch.func.grad`` of ``fn``, vmapped over the elements), and the
Jacobian at a point is a :class:`DiagonalOp` of ``dfn(arr)``.  ``L`` and
``dL`` are the declared Lipschitz and diff-Lipschitz constants (``inf``
where there is none).  ``Abs``, ``Sign``, ``Clip``, ``LeakyReLU`` and
``ReLU`` are not differentiable maps; ``SoftMax`` acts over all core axes
and has the Jacobian diag(p) - p p^T.  The lowercase functional forms
``f(op)`` compose ``F(op.codim_shape) * op`` (or build ``F(shape)``).
"""

from __future__ import annotations

import functools
import math as _math

import torch

from pyxu_tpu_torch.abc.operator import DiffMap, Map, Operator, SelfAdjointOp
from pyxu_tpu_torch.operator.linop.base import DiagonalOp

# as in the JAX package, only the lowercase functional forms are exported;
# the classes are module attributes (pyxu_tpu_torch.operator.map.ufunc.Sin)
__all__ = [
    "sin", "cos", "tan", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
    "exp", "log", "clip", "sqrt", "cbrt", "square", "abs", "sign",
    "gaussian", "sigmoid", "softplus", "leakyrelu", "relu", "silu", "softmax",
]


class ElementWiseMap(DiffMap):
    """x -> fn(x) element by element, with the diagonal Jacobian dfn(x)."""

    _fn = staticmethod(lambda x: x)
    _dfn = None
    _L = _math.inf
    _dL = _math.inf

    def __init__(self, dim_shape):
        super().__init__(dim_shape, dim_shape)
        self._lipschitz = float(self._L)
        self._diff_lipschitz = float(self._dL)

    def apply(self, arr):
        return type(self)._fn(arr)

    def _deriv(self, arr):
        if type(self)._dfn is not None:
            return type(self)._dfn(arr)
        df = torch.func.vmap(torch.func.grad(type(self)._fn))
        return df(arr.reshape(-1)).reshape(arr.shape)

    def jacobian(self, arr):
        arr = torch.as_tensor(arr)
        return DiagonalOp(self._deriv(arr), dim_shape=self.dim_shape)


class _NonDiffElementWise(Map):
    _fn = staticmethod(lambda x: x)
    _L = _math.inf

    def __init__(self, dim_shape):
        super().__init__(dim_shape, dim_shape)
        self._lipschitz = float(self._L)

    def apply(self, arr):
        return type(self)._fn(arr)


def _diff(name, fn, dfn, L, dL):
    return type(name, (ElementWiseMap,), {
        "_fn": staticmethod(fn), "_dfn": staticmethod(dfn), "_L": L,
        "_dL": dL, "__doc__": f"Element-wise {name.lower()}."})


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_INF = _math.inf

Sin = _diff("Sin", torch.sin, torch.cos, 1.0, 1.0)
Cos = _diff("Cos", torch.cos, lambda x: -torch.sin(x), 1.0, 1.0)
Tan = _diff("Tan", torch.tan, lambda x: 1.0 / torch.cos(x) ** 2, _INF, _INF)
ArcSin = _diff("ArcSin", torch.asin, lambda x: 1.0 / torch.sqrt(1 - x * x),
               _INF, _INF)
ArcCos = _diff("ArcCos", torch.acos, lambda x: -1.0 / torch.sqrt(1 - x * x),
               _INF, _INF)
ArcTan = _diff("ArcTan", torch.atan, lambda x: 1.0 / (1 + x * x), 1.0,
               3 * _math.sqrt(3) / 8)
Sinh = _diff("Sinh", torch.sinh, torch.cosh, _INF, _INF)
Cosh = _diff("Cosh", torch.cosh, torch.sinh, _INF, _INF)
Tanh = _diff("Tanh", torch.tanh, lambda x: 1.0 / torch.cosh(x) ** 2, 1.0,
             4 / (3 * _math.sqrt(3)))
ArcSinh = _diff("ArcSinh", torch.asinh,
                lambda x: 1.0 / torch.sqrt(x * x + 1), 1.0,
                2.0 / (3.0 * _math.sqrt(3.0)))
ArcCosh = _diff("ArcCosh", torch.acosh,
                lambda x: 1.0 / torch.sqrt(x * x - 1), _INF, _INF)
ArcTanh = _diff("ArcTanh", torch.atanh, lambda x: 1.0 / (1 - x * x),
                _INF, _INF)
Exp = _diff("Exp", torch.exp, torch.exp, _INF, _INF)
Log = _diff("Log", torch.log, lambda x: 1.0 / x, _INF, _INF)
Sqrt = _diff("Sqrt", torch.sqrt, lambda x: 0.5 / torch.sqrt(x), _INF, _INF)
Cbrt = _diff("Cbrt", _cbrt, lambda x: 1.0 / (3.0 * _cbrt(x * x)), _INF,
             _INF)
Square = _diff("Square", torch.square, lambda x: 2.0 * x, _INF, 2.0)
Gaussian = _diff("Gaussian", lambda x: torch.exp(-x * x),
                 lambda x: -2.0 * x * torch.exp(-x * x),
                 _math.sqrt(2 / _math.e), 2.0)
Sigmoid = _diff("Sigmoid", torch.sigmoid,
                lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x)), 0.25,
                1 / (6 * _math.sqrt(3)))
SoftPlus = _diff("SoftPlus", _softplus, torch.sigmoid, 1.0, 0.25)
SiLU = _diff("SiLU", torch.nn.functional.silu,
             lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(x))),
             1.1, 0.5)


class Abs(_NonDiffElementWise):
    _fn = staticmethod(torch.abs)
    _L = 1.0


class Sign(_NonDiffElementWise):
    _fn = staticmethod(torch.sign)
    _L = _INF


class Clip(_NonDiffElementWise):
    _L = 1.0

    def __init__(self, dim_shape, a_min=None, a_max=None):
        super().__init__(dim_shape)
        if a_min is None and a_max is None:
            raise ValueError("Clip needs a_min or a_max")
        self._amin, self._amax = a_min, a_max

    def apply(self, arr):
        return torch.clamp(arr, self._amin, self._amax)


class LeakyReLU(_NonDiffElementWise):
    def __init__(self, dim_shape, alpha: float):
        super().__init__(dim_shape)
        self._alpha = float(alpha)
        self._lipschitz = max(1.0, _math.fabs(self._alpha))

    def apply(self, arr):
        return torch.where(arr >= 0, arr, self._alpha * arr)


class ReLU(LeakyReLU):
    def __init__(self, dim_shape):
        super().__init__(dim_shape, alpha=0.0)


class SoftMax(DiffMap):
    """Softmax over all core axes; Jacobian diag(p) - p p^T."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, dim_shape)
        self._lipschitz = 1.0
        self._diff_lipschitz = 1.0

    def _axes(self, arr):
        return tuple(range(arr.ndim - self.dim_rank, arr.ndim))

    def apply(self, arr):
        axes = self._axes(arr)
        e = torch.exp(arr - torch.amax(arr, dim=axes, keepdim=True))
        return e / torch.sum(e, dim=axes, keepdim=True)

    def jacobian(self, arr):
        return _SoftMaxJac(self, torch.as_tensor(arr))


class _SoftMaxJac(SelfAdjointOp):
    def __init__(self, op: SoftMax, at):
        super().__init__(op.dim_shape)
        self._p = op.apply(at)
        self._name = "SoftMaxJacobian"

    def apply(self, arr):
        axes = tuple(range(arr.ndim - self.dim_rank, arr.ndim))
        ip = torch.sum(self._p * arr, dim=axes, keepdim=True)
        return self._p * (arr - ip)


def _functional(cls):
    @functools.wraps(cls, updated=())
    def f(op, *args, **kwargs):
        if isinstance(op, Operator):
            return cls(op.codim_shape, *args, **kwargs) * op
        return cls(op, *args, **kwargs)     # called with a shape
    return f


sin = _functional(Sin)
cos = _functional(Cos)
tan = _functional(Tan)
arcsin = _functional(ArcSin)
arccos = _functional(ArcCos)
arctan = _functional(ArcTan)
sinh = _functional(Sinh)
cosh = _functional(Cosh)
tanh = _functional(Tanh)
arcsinh = _functional(ArcSinh)
arccosh = _functional(ArcCosh)
arctanh = _functional(ArcTanh)
exp = _functional(Exp)
log = _functional(Log)
clip = _functional(Clip)
sqrt = _functional(Sqrt)
cbrt = _functional(Cbrt)
square = _functional(Square)
abs = _functional(Abs)  # noqa: A001
sign = _functional(Sign)
gaussian = _functional(Gaussian)
sigmoid = _functional(Sigmoid)
softplus = _functional(SoftPlus)
leakyrelu = _functional(LeakyReLU)
relu = _functional(ReLU)
silu = _functional(SiLU)
softmax = _functional(SoftMax)
