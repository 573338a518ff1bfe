"""The concrete operator library (counterpart of
``pyxu_tpu/operator/__init__.py``)."""

from pyxu_tpu_torch.operator.blocks import (  # noqa: F401
    block,
    block_diag,
    coo_block,
    hstack,
    stack,
    vstack,
)
from pyxu_tpu_torch.operator.func import *  # noqa: F401,F403
from pyxu_tpu_torch.operator.linop import *  # noqa: F401,F403
from pyxu_tpu_torch.operator.map import *  # noqa: F401,F403
from pyxu_tpu_torch.operator.map import ConstantValued  # noqa: F401
