from pyxu_tpu_torch.opt.solver.pds import CV, CondatVu  # noqa: F401
from pyxu_tpu_torch.opt.solver.pgd import PGD  # noqa: F401
