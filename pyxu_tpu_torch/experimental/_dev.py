"""Dev helpers (counterpart of ``pyxu_tpu/experimental/_dev.py``): thin
specializations kept for migration parity; the first-class equivalents are
the norm functionals, ``PartialDerivative.finite_difference`` and
``SubSample``."""

from __future__ import annotations

import numpy as np

from pyxu_tpu_torch.operator.func.norm import L1Norm, SquaredL2Norm  # noqa: F401
from pyxu_tpu_torch.operator.linop.select import SubSample
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = [
    "SquaredL2Norm", "L1Norm", "FirstDerivative", "DownSampling",
    "Masking", "NUFFT1_array", "NUFFT2_array", "NUFFT3_array",
]


def Masking(size: int, sampling_bool):
    """Keep the samples where ``sampling_bool`` is True, a boolean-mask
    :class:`SubSample`."""
    mask = np.asarray(sampling_bool).reshape(-1).astype(bool)
    if mask.size != int(size):
        raise ValueError("Invalid size of boolean sampling array.")
    return SubSample((int(size),), mask)


def NUFFT1_array(x, N, isign) -> np.ndarray:
    """Dense type-1 NUDFT matrix ``exp(i sign B @ x.T)`` with ``B`` the
    centred mode grid, rows ordered like the flattened mode grid (host
    complex numpy)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    D = x.shape[-1]
    if isinstance(N, (int, np.integer)):
        N = (int(N),) * D
    A = np.meshgrid(*[np.arange(-(n // 2), (n - 1) // 2 + 1) for n in N],
                    indexing="ij")
    B = np.stack(A, axis=0).reshape((D, -1)).T
    return np.exp(1j * np.sign(isign) * B @ x.T)


def NUFFT2_array(x, N, isign) -> np.ndarray:
    """Dense type-2 NUDFT matrix: the transpose of the type-1 matrix with
    the same sign."""
    return NUFFT1_array(x, N, isign).T


def NUFFT3_array(x, z, isign) -> np.ndarray:
    """Dense type-3 NUDFT matrix ``exp(i sign z @ x.T)``."""
    x = np.asarray(x, np.float64)
    z = np.asarray(z, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if z.ndim == 1:
        z = z[:, None]
    return np.exp(1j * np.sign(isign) * z @ x.T)


def FirstDerivative(size: int, axis: int = -1, sampling: float = 1.0,
                    kind: str = "forward", device=None):
    """First derivative of a 1-D signal through
    :meth:`PartialDerivative.finite_difference`, with the reference's
    boundary rows zeroed (forward: the last, backward: the first,
    centered: both).  ``device``: that of the boundary mask (default
    ``cuda``)."""
    from pyxu_tpu_torch.operator.linop.base import DiagonalOp
    from pyxu_tpu_torch.operator.linop.diff import PartialDerivative
    scheme = {"forward": "forward", "backward": "backward",
              "centered": "central"}[kind]
    pd = PartialDerivative.finite_difference(
        (int(size),), order=(1,), scheme=scheme, sampling=sampling)
    mask = np.ones(int(size), np.float32)
    if kind == "forward":
        mask[-1] = 0.0
    elif kind == "backward":
        mask[0] = 0.0
    else:
        mask[0] = mask[-1] = 0.0
    return DiagonalOp(mask, device=device) * pd


def DownSampling(size, sampling_rate: int, axis: int = None):
    """Keep every ``sampling_rate``-th sample (along ``axis``, or along
    every axis) through :class:`SubSample`."""
    dim_shape = as_canonical_shape(size)
    idx = []
    for ax, n in enumerate(dim_shape):
        if axis is None or ax == (axis % len(dim_shape)):
            idx.append(slice(0, n, int(sampling_rate)))
        else:
            idx.append(slice(None))
    return SubSample(dim_shape, *idx)
