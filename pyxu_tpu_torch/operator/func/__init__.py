from pyxu_tpu_torch.operator.func.norm import (  # noqa: F401
    L1Norm,
    L21Norm,
    SquaredL2Norm,
)
