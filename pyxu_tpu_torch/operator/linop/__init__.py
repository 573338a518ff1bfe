from pyxu_tpu_torch.operator.linop.base import (  # noqa: F401
    DiagonalOp,
    ExplicitLinFunc,
    ExplicitLinOp,
    HomothetyOp,
    IdentityOp,
    NullFunc,
    NullOp,
    SparseExplicitLinOp,
)
from pyxu_tpu_torch.operator.linop.diff import (  # noqa: F401
    DirectionalDerivative,
    DirectionalGradient,
    DirectionalHessian,
    DirectionalLaplacian,
    Divergence,
    Gradient,
    Hessian,
    Jacobian,
    Laplacian,
    PartialDerivative,
)
from pyxu_tpu_torch.operator.linop.fft import FFT  # noqa: F401
from pyxu_tpu_torch.operator.linop.filter import (  # noqa: F401
    DifferenceOfGaussians,
    DoG,
    Gaussian,
    Laplace,
    MovingAverage,
    Prewitt,
    Scharr,
    Sobel,
    StructureTensor,
)
from pyxu_tpu_torch.operator.linop.kron import khatri_rao, kron  # noqa: F401
from pyxu_tpu_torch.operator.linop.nufft import NUFFT  # noqa: F401
from pyxu_tpu_torch.operator.linop.pad import Pad  # noqa: F401
from pyxu_tpu_torch.operator.linop.reduce import Sum  # noqa: F401
from pyxu_tpu_torch.operator.linop.select import SubSample, Trim  # noqa: F401
from pyxu_tpu_torch.operator.linop.stencil import (  # noqa: F401
    Convolve,
    Correlate,
    Stencil,
)
from pyxu_tpu_torch.operator.linop.xray import FourierRadon, RadonTransform  # noqa: F401
