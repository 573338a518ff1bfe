from pyxu_tpu_torch.utils.complex import (  # noqa: F401
    complex_dtype,
    real_dtype,
    view_as_complex,
    view_as_complex_mat,
    view_as_real,
    view_as_real_mat,
)
from pyxu_tpu_torch.utils.inspect import import_module, parse_params  # noqa: F401
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
from pyxu_tpu_torch.utils.vectorize import (  # noqa: F401
    batched_over,
    flatten_batch,
    unflatten_batch,
    vectorize,
)
from pyxu_tpu_torch.utils.array_module import (  # noqa: F401
    compute,
    copy_if_unsafe,
    get_array_module,
    read_only,
    redirect,
    to_numpy,
)
from pyxu_tpu_torch.utils.profiler import timed, trace  # noqa: F401

to_NUMPY = to_numpy  # reference spelling
