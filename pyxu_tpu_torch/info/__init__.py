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
from pyxu_tpu_torch.info.deps import (  # noqa: F401
    CUPY_ENABLED,
    JAX_SUPPORT,
    PYTORCH_SUPPORT,
    NDArrayInfo,
    SparseArrayInfo,
    supported_array_modules,
    supported_array_types,
    supported_sparse_modules,
    supported_sparse_types,
)
from pyxu_tpu_torch.info.plugin import (  # noqa: F401
    PLUGIN_GROUPS,
    discover_plugins,
    load_plugins,
)
