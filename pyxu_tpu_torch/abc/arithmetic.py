"""Operator arithmetic rule engine (counterpart of ``pyxu_tpu/abc/arithmetic.py``).

Each rule is a mixin class whose methods close over the operand operators;
the output class is ``type(name, (Mixin, InferredCoreClass), {})``, built
once per (mixin, class) pair, so ``isinstance(op, LinOp)``-style checks keep
working on composites.  Quadratics are closed under positive scaling,
argument shifts, addition of linear functionals and composition with a
linear operator: those rules rebuild a genuine ``QuadraticFunc`` whose
``(Q, c, t)`` spec is itself made of composed operators.  Lipschitz
constants propagate through every rule.

Ported rules: Scale, ArgShift, Add, Chain (with ``compose``), Transpose and
Cast, each with its Lipschitz estimators.  ArgScale and Power are not
ported yet; neither the TV nor the LASSO path reaches them.
"""

from __future__ import annotations

import functools
import math as _math

import torch

from pyxu_tpu_torch.abc.operator import (
    LinFunc,
    LinOp,
    Operator,
    PosDefOp,
    Property as P,
    QuadraticFunc,
    _autograd_grad,
    infer_operator_class,
)

__all__ = ["add", "compose", "scale", "argshift", "transpose", "cast_op"]

_LINEAR_SUBPROPS = frozenset({
    P.LINEAR_SQUARE, P.LINEAR_NORMAL, P.LINEAR_IDEMPOTENT,
    P.LINEAR_SELF_ADJOINT, P.LINEAR_POSITIVE_DEFINITE, P.LINEAR_UNITARY,
})


@functools.cache
def _composite_class(mixin: type, klass: type) -> type:
    return type(f"{mixin.__name__}[{klass.__name__}]", (mixin, klass), {})


def _make(mixin: type, properties: frozenset, *args) -> Operator:
    return _composite_class(mixin, infer_operator_class(properties))(*args)


def _finite(x: float) -> bool:
    return x != _math.inf and not _math.isnan(x)


# ===================================================================== scale =

class ScaleMixin:
    """out = cst * op."""

    def __init__(self, op: Operator, cst: float):
        Operator.__init__(self, op.dim_shape, op.codim_shape)
        self._op = op
        self._cst = float(cst)
        self._name = "Scale"
        if _finite(op._lipschitz):
            self._lipschitz = abs(cst) * op._lipschitz
        if _finite(op._diff_lipschitz):
            self._diff_lipschitz = abs(cst) * op._diff_lipschitz

    def apply(self, arr):
        return self._cst * self._op.apply(arr)

    def grad(self, arr):
        return self._cst * self._op.grad(arr)

    def adjoint(self, arr):
        return self._cst * self._op.adjoint(arr)

    def prox(self, arr, tau):
        if self._op.has(P.PROXIMABLE) and self._cst > 0:
            return self._op.prox(arr, self._cst * tau)
        if self.has(P.LINEAR, P.FUNCTIONAL):
            return arr - tau * self.grad(arr)
        raise NotImplementedError

    def estimate_lipschitz(self, **kw):
        self._lipschitz = abs(self._cst) * self._op.estimate_lipschitz(**kw)
        return self._lipschitz

    def estimate_diff_lipschitz(self, **kw):
        self._diff_lipschitz = abs(self._cst) * \
            self._op.estimate_diff_lipschitz(**kw)
        return self._diff_lipschitz


def _scale_properties(op: Operator, cst: float) -> frozenset:
    p = set(op.properties())
    if cst < 0:
        if not op.has(P.LINEAR, P.FUNCTIONAL):
            p.discard(P.PROXIMABLE)
            p.discard(P.QUADRATIC)
        p.discard(P.LINEAR_POSITIVE_DEFINITE)
    if abs(cst) != 1.0:
        p.discard(P.LINEAR_UNITARY)
    if cst != 1.0:
        p.discard(P.LINEAR_IDEMPOTENT)
    return frozenset(p)


def scale(op: Operator, cst: float) -> Operator:
    cst = float(cst)
    if cst == 1.0:
        return op
    if cst == 0.0:
        from pyxu_tpu_torch.operator.linop.base import NullFunc, NullOp
        if op.has(P.FUNCTIONAL):
            return NullFunc(op.dim_shape)
        return NullOp(op.dim_shape, op.codim_shape)
    if isinstance(op, ScaleMixin):
        return scale(op._op, cst * op._cst)
    if op.has(P.QUADRATIC) and cst > 0:
        Q, c, t = op._quad_spec()
        return QuadraticFunc(op.dim_shape, Q=scale(Q, cst).asop(PosDefOp),
                             c=scale(c, cst), t=cst * t)
    return _make(ScaleMixin, _scale_properties(op, cst), op, cst)


# ================================================================== argshift =

class ArgShiftMixin:
    """out = op(. + s)."""

    def __init__(self, op: Operator, shift):
        Operator.__init__(self, op.dim_shape, op.codim_shape)
        self._op = op
        self._shift = shift
        self._name = "ArgShift"
        if _finite(op._lipschitz):
            self._lipschitz = op._lipschitz
        if _finite(op._diff_lipschitz):
            self._diff_lipschitz = op._diff_lipschitz

    def apply(self, arr):
        return self._op.apply(arr + self._shift)

    def grad(self, arr):
        return self._op.grad(arr + self._shift)

    def prox(self, arr, tau):
        return self._op.prox(arr + self._shift, tau) - self._shift

    def estimate_lipschitz(self, **kw):
        self._lipschitz = self._op.estimate_lipschitz(**kw)
        return self._lipschitz

    def estimate_diff_lipschitz(self, **kw):
        self._diff_lipschitz = self._op.estimate_diff_lipschitz(**kw)
        return self._diff_lipschitz


def _argshift_properties(op: Operator) -> frozenset:
    p = set(op.properties())
    p.discard(P.LINEAR)
    return frozenset(p - _LINEAR_SUBPROPS)


def argshift(op: Operator, shift) -> Operator:
    shift = torch.as_tensor(shift)
    if op.has(P.QUADRATIC):
        from pyxu_tpu_torch.operator.linop.base import ExplicitLinFunc
        Q, c, t = op._quad_spec()
        Qs = Q.apply(shift)
        c_new = add(c, ExplicitLinFunc(Qs))
        # t stays a 0-d tensor on the data's device (no host sync)
        t_new = 0.5 * torch.sum(shift * Qs) + c.apply(shift) + t
        return QuadraticFunc(op.dim_shape, Q=Q, c=c_new, t=t_new)
    return _make(ArgShiftMixin, _argshift_properties(op), op, shift)


# ======================================================================= add =

class AddMixin:
    """out = lhs + rhs."""

    def __init__(self, lhs: Operator, rhs: Operator):
        Operator.__init__(self, lhs.dim_shape, lhs.codim_shape)
        self._lhs = lhs
        self._rhs = rhs
        self._name = "Add"
        if _finite(lhs._lipschitz) and _finite(rhs._lipschitz):
            self._lipschitz = lhs._lipschitz + rhs._lipschitz
        if _finite(lhs._diff_lipschitz) and _finite(rhs._diff_lipschitz):
            self._diff_lipschitz = lhs._diff_lipschitz + rhs._diff_lipschitz

    def apply(self, arr):
        return self._lhs.apply(arr) + self._rhs.apply(arr)

    def grad(self, arr):
        return self._lhs.grad(arr) + self._rhs.grad(arr)

    def adjoint(self, arr):
        return self._lhs.adjoint(arr) + self._rhs.adjoint(arr)

    def prox(self, arr, tau):
        # prox_{f + <w,.>}(x) = prox_f(x - tau w)
        if self._lhs.has(P.PROXIMABLE) and self._rhs.has(P.LINEAR, P.FUNCTIONAL):
            f, lin = self._lhs, self._rhs
        elif self._rhs.has(P.PROXIMABLE) and self._lhs.has(P.LINEAR, P.FUNCTIONAL):
            f, lin = self._rhs, self._lhs
        else:
            raise NotImplementedError
        return f.prox(arr - tau * lin.grad(arr), tau)

    def estimate_lipschitz(self, **kw):
        if self.has(P.LINEAR):      # tight estimate on the composite
            self._lipschitz = LinOp.estimate_lipschitz(self, **kw)
        else:
            self._lipschitz = (self._lhs.estimate_lipschitz(**kw)
                               + self._rhs.estimate_lipschitz(**kw))
        return self._lipschitz

    def estimate_diff_lipschitz(self, **kw):
        self._diff_lipschitz = (self._lhs.estimate_diff_lipschitz(**kw)
                                + self._rhs.estimate_diff_lipschitz(**kw))
        return self._diff_lipschitz


def _add_properties(lhs: Operator, rhs: Operator) -> frozenset:
    lp, rp = lhs.properties(), rhs.properties()
    p = set()
    for prop in (P.CAN_EVAL, P.FUNCTIONAL, P.DIFFERENTIABLE,
                 P.DIFFERENTIABLE_FUNCTION, P.LINEAR, P.LINEAR_SQUARE):
        if prop in lp and prop in rp:
            p.add(prop)
    if P.LINEAR_SELF_ADJOINT in lp and P.LINEAR_SELF_ADJOINT in rp:
        p |= {P.LINEAR_SELF_ADJOINT, P.LINEAR_NORMAL}
        if P.LINEAR_POSITIVE_DEFINITE in lp and P.LINEAR_POSITIVE_DEFINITE in rp:
            p.add(P.LINEAR_POSITIVE_DEFINITE)
    quad = (
        (P.QUADRATIC in lp and P.QUADRATIC in rp)
        or (P.QUADRATIC in lp and rhs.has(P.LINEAR, P.FUNCTIONAL))
        or (P.QUADRATIC in rp and lhs.has(P.LINEAR, P.FUNCTIONAL))
    )
    if quad:
        p.add(P.QUADRATIC)
        p.discard(P.LINEAR)
        p -= _LINEAR_SUBPROPS
    prox_ok = (
        (P.PROXIMABLE in lp and rhs.has(P.LINEAR, P.FUNCTIONAL))
        or (P.PROXIMABLE in rp and lhs.has(P.LINEAR, P.FUNCTIONAL))
    )
    if (prox_ok or (P.LINEAR in p and P.FUNCTIONAL in p) or quad) \
            and P.FUNCTIONAL in p:
        p.add(P.PROXIMABLE)
    return frozenset(p)


def add(lhs: Operator, rhs: Operator) -> Operator:
    if lhs.dim_shape != rhs.dim_shape or lhs.codim_shape != rhs.codim_shape:
        raise ValueError(f"shape mismatch: {lhs} + {rhs}")
    from pyxu_tpu_torch.operator.linop.base import NullFunc, NullOp
    if isinstance(lhs, (NullOp, NullFunc)):
        return rhs
    if isinstance(rhs, (NullOp, NullFunc)):
        return lhs
    props = _add_properties(lhs, rhs)
    if P.QUADRATIC in props:
        ql, qr = lhs.has(P.QUADRATIC), rhs.has(P.QUADRATIC)
        if ql and qr:
            Q1, c1, t1 = lhs._quad_spec()
            Q2, c2, t2 = rhs._quad_spec()
            return QuadraticFunc(lhs.dim_shape, Q=add(Q1, Q2).asop(PosDefOp),
                                 c=add(c1, c2), t=t1 + t2)
        quad, lin = (lhs, rhs) if ql else (rhs, lhs)
        Q, c, t = quad._quad_spec()
        return QuadraticFunc(lhs.dim_shape, Q=Q, c=add(c, lin), t=t)
    return _make(AddMixin, props, lhs, rhs)


# ===================================================================== chain =

class ChainMixin:
    """out = lhs o rhs."""

    def __init__(self, lhs: Operator, rhs: Operator):
        Operator.__init__(self, rhs.dim_shape, lhs.codim_shape)
        self._lhs = lhs
        self._rhs = rhs
        self._cgrad_w = {}
        self._name = "Chain"
        if _finite(lhs._lipschitz) and _finite(rhs._lipschitz):
            self._lipschitz = lhs._lipschitz * rhs._lipschitz
        if lhs.has(P.LINEAR) and rhs.has(P.LINEAR):
            self._diff_lipschitz = 0.0
        elif rhs.has(P.LINEAR) and _finite(lhs._diff_lipschitz) \
                and _finite(rhs._lipschitz):
            self._diff_lipschitz = lhs._diff_lipschitz * rhs._lipschitz ** 2
        elif lhs.has(P.LINEAR) and _finite(lhs._lipschitz) \
                and _finite(rhs._diff_lipschitz):
            self._diff_lipschitz = lhs._lipschitz * rhs._diff_lipschitz

    def apply(self, arr):
        return self._lhs.apply(self._rhs.apply(arr))

    def adjoint(self, arr):
        return self._rhs.adjoint(self._lhs.adjoint(arr))

    def grad(self, arr):
        if self._rhs.has(P.LINEAR):
            if self._lhs.has(P.LINEAR):
                # linear-functional chain: the gradient is the CONSTANT
                # w = K^T grad(l).  It is computed once per (dtype, device)
                # and cached, so a solver loop does not re-run K forward and
                # adjoint every iteration only to rebuild it.
                key = (arr.dtype, arr.device)
                w = self._cgrad_w.get(key)
                if w is None:
                    w = self._cgrad_w[key] = self._rhs.adjoint(self._lhs.grad(
                        torch.zeros(self._lhs.dim_shape, dtype=arr.dtype,
                                    device=arr.device)))
                return w.expand(arr.shape)
            return self._rhs.adjoint(self._lhs.grad(self._rhs.apply(arr)))
        return _autograd_grad(self, arr)

    def prox(self, arr, tau):
        if self.has(P.LINEAR, P.FUNCTIONAL):
            return LinFunc.prox(self, arr, tau)
        raise NotImplementedError

    def estimate_lipschitz(self, **kw):
        if self.has(P.LINEAR):
            self._lipschitz = LinOp.estimate_lipschitz(self, **kw)
        else:
            self._lipschitz = (self._lhs.estimate_lipschitz(**kw)
                               * self._rhs.estimate_lipschitz(**kw))
        return self._lipschitz

    def estimate_diff_lipschitz(self, **kw):
        """Linear chain: 0; f o K with K linear: dL_f ||K||^2; K o g with
        K linear: ||K|| dL_g; non-linear o non-linear: no finite bound."""
        if self.has(P.LINEAR):
            dL = 0.0
        elif self._rhs.has(P.LINEAR):
            Lr = self._rhs.estimate_lipschitz(**kw)
            dL = self._lhs.estimate_diff_lipschitz(**kw) * Lr ** 2
        elif self._lhs.has(P.LINEAR):
            dL = (self._lhs.estimate_lipschitz(**kw)
                  * self._rhs.estimate_diff_lipschitz(**kw))
        else:
            dL = _math.inf
        self._diff_lipschitz = dL
        return dL


def _chain_properties(lhs: Operator, rhs: Operator) -> frozenset:
    lp, rp = lhs.properties(), rhs.properties()
    p = {P.CAN_EVAL}
    if P.FUNCTIONAL in lp:
        p.add(P.FUNCTIONAL)
    if P.DIFFERENTIABLE in lp and P.DIFFERENTIABLE in rp:
        p.add(P.DIFFERENTIABLE)
    if P.DIFFERENTIABLE_FUNCTION in lp and P.DIFFERENTIABLE in rp:
        p.add(P.DIFFERENTIABLE_FUNCTION)
    if P.LINEAR in lp and P.LINEAR in rp:
        p.add(P.LINEAR)
        if rhs.dim_shape == lhs.codim_shape:
            p.add(P.LINEAR_SQUARE)
        if P.LINEAR_UNITARY in lp and P.LINEAR_UNITARY in rp:
            p |= {P.LINEAR_UNITARY, P.LINEAR_NORMAL, P.LINEAR_SQUARE}
    if P.PROXIMABLE in lp and P.LINEAR_UNITARY in rp:
        p.add(P.PROXIMABLE)
    if P.QUADRATIC in lp and P.LINEAR in rp:
        p |= {P.QUADRATIC, P.PROXIMABLE}
        p.discard(P.LINEAR)
    if P.LINEAR in p and P.FUNCTIONAL in p:
        p |= {P.PROXIMABLE, P.DIFFERENTIABLE_FUNCTION}
    return frozenset(p)


def compose(lhs: Operator, rhs: Operator) -> Operator:
    if rhs.codim_shape != lhs.dim_shape:
        raise ValueError(f"shape mismatch in composition: {lhs} o {rhs}")
    from pyxu_tpu_torch.operator.linop.base import IdentityOp, NullFunc, NullOp
    if isinstance(lhs, IdentityOp):
        return rhs
    if isinstance(rhs, IdentityOp):
        return lhs
    if isinstance(lhs, (NullOp, NullFunc)):
        if lhs.has(P.FUNCTIONAL):
            return NullFunc(rhs.dim_shape)
        return NullOp(rhs.dim_shape, lhs.codim_shape)
    props = _chain_properties(lhs, rhs)
    if P.QUADRATIC in props and lhs.has(P.QUADRATIC):
        Q, c, t = lhs._quad_spec()
        cst = _homothety_cst(Q)
        if cst is not None and cst > 0:
            # Q == cst*I, so Q_new = cst * K^T K, routed through K.gram()
            Q_new = scale(rhs.gram(), cst).asop(PosDefOp)
        else:
            Q_new = compose(transpose(rhs), compose(Q, rhs)).asop(PosDefOp)
        return QuadraticFunc(rhs.dim_shape, Q=Q_new, c=compose(c, rhs), t=t)
    return _make(ChainMixin, props, lhs, rhs)


def _homothety_cst(Q: Operator):
    """cst if Q == cst * Identity (Identity / Homothety / scale-wrappers
    thereof), else None."""
    from pyxu_tpu_torch.operator.linop.base import HomothetyOp, IdentityOp
    if isinstance(Q, IdentityOp):
        return 1.0
    if isinstance(Q, HomothetyOp):
        return Q._cst
    if isinstance(Q, ScaleMixin):
        inner = _homothety_cst(Q._op)
        return None if inner is None else Q._cst * inner
    return None


# ================================================================= transpose =

class TransposeMixin:
    """out = op^T."""

    def __init__(self, op: Operator):
        Operator.__init__(self, op.codim_shape, op.dim_shape)
        self._op = op
        self._name = "Transpose"
        if _finite(op._lipschitz):
            self._lipschitz = op._lipschitz
        self._diff_lipschitz = 0.0

    def apply(self, arr):
        return self._op.adjoint(arr)

    def adjoint(self, arr):
        return self._op.apply(arr)

    def estimate_lipschitz(self, **kw):
        self._lipschitz = self._op.estimate_lipschitz(**kw)
        return self._lipschitz


def transpose(op: Operator) -> Operator:
    if not op.has(P.LINEAR):
        raise ValueError("transpose requires a linear operator")
    if op.has(P.LINEAR_SELF_ADJOINT):
        return op
    if isinstance(op, TransposeMixin):
        return op._op
    p = set(op.properties()) & {
        P.CAN_EVAL, P.DIFFERENTIABLE, P.LINEAR, P.LINEAR_SQUARE,
        P.LINEAR_NORMAL, P.LINEAR_UNITARY, P.LINEAR_IDEMPOTENT}
    return _make(TransposeMixin, frozenset(p), op)


# ====================================================================== cast =

class CastMixin:
    """asop() recast wrapper."""

    def __init__(self, op: Operator):
        codim = () if (self.has(P.FUNCTIONAL) and op.codim_size == 1) \
            else op.codim_shape
        Operator.__init__(self, op.dim_shape, codim)
        self._op = op
        self._squeeze_rank = op.codim_rank if codim == () else 0
        self._name = f"Cast[{op.name}]"
        if _finite(op._lipschitz):
            self._lipschitz = op._lipschitz
        if _finite(op._diff_lipschitz):
            self._diff_lipschitz = op._diff_lipschitz

    def apply(self, arr):
        out = self._op.apply(arr)
        if self._squeeze_rank:
            out = out.reshape(out.shape[: out.ndim - self._squeeze_rank])
        return out

    def adjoint(self, arr):
        if self.has(P.LINEAR_SELF_ADJOINT):
            return self.apply(arr)
        if self._op.has(P.LINEAR):
            if self._squeeze_rank:
                arr = arr.reshape(arr.shape + (1,) * self._squeeze_rank)
            return self._op.adjoint(arr)
        return LinOp.adjoint(self, arr)

    def grad(self, arr):
        if self._op.has(P.DIFFERENTIABLE_FUNCTION):
            return self._op.grad(arr)
        if self.has(P.LINEAR, P.FUNCTIONAL):
            return LinFunc.grad(self, arr)
        return _autograd_grad(self, arr)

    def prox(self, arr, tau):
        if self._op.has(P.PROXIMABLE):
            return self._op.prox(arr, tau)
        if self.has(P.LINEAR, P.FUNCTIONAL):
            return LinFunc.prox(self, arr, tau)
        raise NotImplementedError(f"{self._name}: inner operator has no prox")

    def _quad_spec(self):
        if self._op.has(P.QUADRATIC):
            return self._op._quad_spec()
        raise NotImplementedError(
            f"{self._name}: the inner operator carries no quadratic spec")

    def estimate_lipschitz(self, **kw):
        if self.has(P.LINEAR) and not self._op.has(P.LINEAR):
            L = LinOp.estimate_lipschitz(self, **kw)
        else:
            L = self._op.estimate_lipschitz(**kw)
        self._lipschitz = L
        return L

    def estimate_diff_lipschitz(self, **kw):
        # the inner operator's: the cast class's own estimator may read
        # fields (QuadraticFunc._Q) that a cast never sets
        self._diff_lipschitz = self._op.estimate_diff_lipschitz(**kw)
        return self._diff_lipschitz


def cast_op(op: Operator, cast_to: type) -> Operator:
    if type(op) is cast_to or (
            isinstance(op, cast_to) and cast_to.properties() == op.properties()):
        return op
    if isinstance(op, CastMixin) and \
            cast_to.properties() <= type(op._op).properties():
        return cast_op(op._op, cast_to)
    if not issubclass(cast_to, Operator):
        raise ValueError(f"cannot cast to non-operator {cast_to}")
    return _composite_class(CastMixin, cast_to)(op)
