"""PyTorch/CUDA port of :mod:`pyxu_tpu` for NVIDIA Hopper.

Module paths and public names follow ``pyxu_tpu`` so each module's
counterpart is easy to find.  The package imports ``torch`` and ``numpy``
only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` or CPU tensors; with no device given and no GPU present
they raise instead of carrying on on the CPU.

TF32 is turned off here: a 10-bit mantissa cannot meet the f32 conformance
tolerance (atol 2e-4) that the port is held to.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = []
