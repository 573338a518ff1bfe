from pyxu_tpu_torch.utils.complex import (  # noqa: F401
    complex_dtype,
    real_dtype,
    view_as_complex,
    view_as_complex_mat,
    view_as_real,
    view_as_real_mat,
)
from pyxu_tpu_torch.utils.misc import (  # noqa: F401
    as_canonical_shape,
    asarray_astype,
    broadcast_shapes_leading,
    infer_composition_shape,
    infer_sum_shape,
    next_fast_len,
    peaks,
    star_like_sample,
)
