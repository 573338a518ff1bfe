from pyxu_tpu_torch.sampler._sampler import MYULA, ULA, Sampler, _Sampler  # noqa: F401
from pyxu_tpu_torch.sampler.statistics import (  # noqa: F401
    OnlineCenteredMoment,
    OnlineKurtosis,
    OnlineMoment,
    OnlineSkewness,
    OnlineStat,
    OnlineStd,
    OnlineVariance,
)
