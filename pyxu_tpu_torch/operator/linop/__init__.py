from pyxu_tpu_torch.operator.linop.base import (  # noqa: F401
    ExplicitLinFunc,
    HomothetyOp,
    IdentityOp,
    NullFunc,
    NullOp,
)
from pyxu_tpu_torch.operator.linop.diff import Gradient, PartialDerivative  # noqa: F401
from pyxu_tpu_torch.operator.linop.pad import Pad  # noqa: F401
from pyxu_tpu_torch.operator.linop.stencil import (  # noqa: F401
    Convolve,
    Correlate,
    Stencil,
)
from pyxu_tpu_torch.operator.linop.filter import (  # noqa: F401
    DifferenceOfGaussians,
    DoG,
    Gaussian,
    Laplace,
    MovingAverage,
    Prewitt,
    Scharr,
    Sobel,
)
