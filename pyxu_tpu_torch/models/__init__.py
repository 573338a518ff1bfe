from pyxu_tpu_torch.models.workloads import (  # noqa: F401
    lasso_deconvolution,
    tv_deconvolution,
)
