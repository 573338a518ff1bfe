from pyxu_tpu_torch.utils.misc import (  # noqa: F401
    as_canonical_shape,
    asarray_astype,
    peaks,
)
