from pyxu_tpu_torch.opt.solver.cg import CG  # noqa: F401
from pyxu_tpu_torch.opt.solver.pds import (  # noqa: F401
    ADMM,
    CP,
    CV,
    DR,
    DY,
    FB,
    LV,
    PD3O,
    PP,
    ChambollePock,
    CondatVu,
    DavisYin,
    DouglasRachford,
    ForwardBackward,
    LorisVerhoeven,
    ProximalPoint,
)
from pyxu_tpu_torch.opt.solver.nlcg import NLCG  # noqa: F401
from pyxu_tpu_torch.opt.solver.pgd import PGD  # noqa: F401
from pyxu_tpu_torch.opt.solver.prox_adam import ProxAdam  # noqa: F401
