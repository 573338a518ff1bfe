from pyxu_tpu_torch.operator.map.base import ConstantValued  # noqa: F401
