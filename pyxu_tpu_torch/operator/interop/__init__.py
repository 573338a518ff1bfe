from pyxu_tpu_torch.operator.interop.source import from_source  # noqa: F401
