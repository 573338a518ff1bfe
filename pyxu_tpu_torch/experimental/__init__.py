"""Reference namespace parity: ``experimental`` hosted the MCMC samplers
and a handful of dev helpers.  Here the samplers are first-class
(:mod:`pyxu_tpu_torch.sampler`); this package keeps the reference import
paths working."""

import sys as _sys

from pyxu_tpu_torch import sampler  # noqa: F401
from pyxu_tpu_torch.experimental import _dev  # noqa: F401

# make `import pyxu_tpu_torch.experimental.sampler` resolve as a module,
# not just an attribute
_sys.modules[__name__ + ".sampler"] = sampler
