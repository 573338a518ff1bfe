from pyxu_tpu_torch.opt.solver.pds import CV, CondatVu  # noqa: F401
