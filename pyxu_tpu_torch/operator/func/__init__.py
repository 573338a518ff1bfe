from pyxu_tpu_torch.operator.func.indicator import (  # noqa: F401
    AffineSet,
    ConvexSetIntersection,
    HyperSlab,
    L1Ball,
    L2Ball,
    LInfinityBall,
    PositiveOrthant,
    RangeSet,
)
from pyxu_tpu_torch.operator.func.loss import shift_loss  # noqa: F401
from pyxu_tpu_torch.operator.func.norm import (  # noqa: F401
    L1Norm,
    L2Norm,
    L21Norm,
    LInfinityNorm,
    PositiveL1Norm,
    SquaredL1Norm,
    SquaredL2Norm,
)
