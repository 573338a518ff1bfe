from pyxu_tpu_torch.abc.operator import (  # noqa: F401
    DiffFunc,
    DiffMap,
    Func,
    LinFunc,
    LinOp,
    Map,
    NormalOp,
    Operator,
    PosDefOp,
    Property,
    ProxDiffFunc,
    ProxFunc,
    QuadraticFunc,
    SelfAdjointOp,
    SquareOp,
    core_operators,
    infer_operator_class,
)
from pyxu_tpu_torch.abc import arithmetic  # noqa: F401
from pyxu_tpu_torch.abc.solver import Mode, Solver, StoppingCriterion  # noqa: F401
