from pyxu_tpu_torch.operator.map.base import ConstantValued  # noqa: F401
from pyxu_tpu_torch.operator.map.ufunc import *  # noqa: F401,F403
