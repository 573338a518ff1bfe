"""Backend registry (counterpart of ``pyxu_tpu/info/deps.py``).

The port has one compute backend, PyTorch (CPU or CUDA tensors), with
numpy as the host staging module; sparse arrays are torch sparse tensors
or scipy matrices.  It takes no JAX arrays.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "NDArrayInfo",
    "SparseArrayInfo",
    "supported_array_types",
    "supported_array_modules",
    "supported_sparse_types",
    "supported_sparse_modules",
    "CUPY_ENABLED",
    "JAX_SUPPORT",
    "PYTORCH_SUPPORT",
]

CUPY_ENABLED: bool = False   # CUDA arrays are torch tensors, not CuPy's
JAX_SUPPORT: bool = False    # the port imports no JAX
PYTORCH_SUPPORT: bool = True


class NDArrayInfo(enum.Enum):
    """Dense-backend registry."""

    NUMPY = enum.auto()  # host staging arrays
    TORCH = enum.auto()  # the compute backend (CPU or CUDA)

    def module(self):
        return np if self is NDArrayInfo.NUMPY else torch

    def type(self) -> type:
        return np.ndarray if self is NDArrayInfo.NUMPY else torch.Tensor

    @classmethod
    def from_obj(cls, obj) -> "NDArrayInfo":
        if isinstance(obj, torch.Tensor) and obj.layout == torch.strided:
            return cls.TORCH
        if isinstance(obj, np.ndarray):
            return cls.NUMPY
        raise ValueError(f"unsupported array type {type(obj)}")

    @classmethod
    def from_flag(cls, gpu: bool = False) -> "NDArrayInfo":
        # the reference keys on gpu=True -> CUPY; both devices are torch's
        return cls.TORCH


class SparseArrayInfo(enum.Enum):
    """Sparse-backend registry: scipy matrices on the host, torch sparse
    tensors (COO, CSR, CSC, BSR, BSC) for compute."""

    SCIPY = enum.auto()
    TORCH_SPARSE = enum.auto()

    def module(self):
        if self is SparseArrayInfo.SCIPY:
            import scipy.sparse as sp
            return sp
        return torch.sparse

    @classmethod
    def from_obj(cls, obj) -> "SparseArrayInfo":
        import scipy.sparse as sp
        if sp.issparse(obj):
            return cls.SCIPY
        if isinstance(obj, torch.Tensor) and obj.layout != torch.strided:
            return cls.TORCH_SPARSE
        raise ValueError(f"unsupported sparse type {type(obj)}")


def supported_array_types() -> tuple:
    return tuple(info.type() for info in NDArrayInfo)


def supported_array_modules() -> tuple:
    return tuple(info.module() for info in NDArrayInfo)


def supported_sparse_types() -> tuple:
    import scipy.sparse as sp
    return (sp.spmatrix, sp.sparray, torch.Tensor)


def supported_sparse_modules() -> tuple:
    return tuple(info.module() for info in SparseArrayInfo)
