"""Type vocabulary for annotating the public API (counterpart of
``pyxu_tpu/info/ptype.py``).  The port computes on one array type,
``torch.Tensor``."""

from __future__ import annotations

import numbers
import os
import typing as typ

import numpy as np
import torch

__all__ = [
    "NDArray",
    "ArrayModule",
    "OpT",
    "OpC",
    "SolverT",
    "SolverC",
    "SolverM",
    "OpShape",
    "NDArrayAxis",
    "NDArrayShape",
    "Integer",
    "Real",
    "DType",
    "Path",
    "VarName",
]

NDArray = torch.Tensor
ArrayModule = typ.Any  # torch (compute) or numpy (host staging)
OpT = typ.TypeVar("OpT", bound="pyxu_tpu_torch.abc.operator.Operator")  # noqa: F821
OpC = typ.Type[OpT]
SolverT = typ.TypeVar("SolverT", bound="pyxu_tpu_torch.abc.solver.Solver")  # noqa: F821
SolverC = typ.Type[SolverT]
SolverM = typ.Any  # pyxu_tpu_torch.abc.solver.Mode
OpShape = typ.Tuple[int, ...]
NDArrayAxis = typ.Union[int, typ.Tuple[int, ...]]
NDArrayShape = typ.Union[int, typ.Tuple[int, ...]]
Integer = numbers.Integral
Real = numbers.Real
DType = typ.Union[str, type, np.dtype, torch.dtype]
Path = typ.Union[str, os.PathLike]
VarName = typ.Union[str, typ.Collection[str]]
