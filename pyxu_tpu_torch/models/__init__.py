from pyxu_tpu_torch.models.workloads import (  # noqa: F401
    consensus_tiles,
    lasso_deconvolution,
    radio_interferometry,
    sparse_view_ct,
    tv_deconvolution,
)
