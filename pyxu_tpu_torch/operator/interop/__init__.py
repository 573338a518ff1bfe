from pyxu_tpu_torch.operator.interop.sciop import from_sciop  # noqa: F401
from pyxu_tpu_torch.operator.interop.source import from_source  # noqa: F401
from pyxu_tpu_torch.operator.interop.torch import (  # noqa: F401
    asarray,
    astensor,
    from_torch,
)
