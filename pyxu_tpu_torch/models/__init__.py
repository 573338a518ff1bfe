from pyxu_tpu_torch.models.workloads import tv_deconvolution  # noqa: F401
