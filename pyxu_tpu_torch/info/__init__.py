from pyxu_tpu_torch.info.dtypes import (  # noqa: F401
    CWidth,
    EnforcePrecision,
    Precision,
    Width,
    atol_for,
    coerce,
    default_cdtype,
    default_fdtype,
    enforce_precision,
    getCoerceState,
    getPrecision,
    lowered_matmul_precision,
    set_default_width,
)
from pyxu_tpu_torch.info import warnings  # noqa: F401
