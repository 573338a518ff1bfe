from pyxu_tpu_torch.info.dtypes import (  # noqa: F401
    Precision,
    Width,
    atol_for,
    default_fdtype,
    getPrecision,
    set_default_width,
)
from pyxu_tpu_torch.info import warnings  # noqa: F401
