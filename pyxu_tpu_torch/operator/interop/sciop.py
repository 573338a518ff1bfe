"""Wrap a ``scipy.sparse.linalg.LinearOperator`` as a LinOp (counterpart of
``pyxu_tpu/operator/interop/sciop.py``).

A SciPy operator runs on the host.  On a CUDA tensor each apply or adjoint
copies the input to the host (a wait for the device, counted in
``runtime.host_read.count``), runs the SciPy operator there, one
``matmat``/``rmatmat`` for the whole batch where it has one, and copies
the result back; on a CPU tensor it runs in place of both copies.
"""

from __future__ import annotations

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import LinOp
from pyxu_tpu_torch.runtime import host_read

__all__ = ["from_sciop"]


class _SciOp(LinOp):
    def __init__(self, sp_op):
        M, N = sp_op.shape
        super().__init__((N,), (M,))
        self._sp = sp_op
        self._name = "SciOp"

    def _call(self, fn, fn_mat, arr, n_in, n_out):
        if arr.device.type != "cpu":
            host_read.count += 1
        a = arr.detach().cpu().numpy()
        flat = a.reshape(-1, n_in)
        if flat.shape[0] == 0:
            out = np.zeros((0, n_out), a.dtype)
        elif fn_mat is not None:
            out = np.asarray(fn_mat(flat.T)).T
        else:
            out = np.stack([np.asarray(fn(v)).ravel() for v in flat])
        out = out.reshape(a.shape[:-1] + (n_out,)).astype(a.dtype)
        return torch.from_numpy(np.ascontiguousarray(out)).to(arr.device)

    def apply(self, arr):
        return self._call(self._sp.matvec, getattr(self._sp, "matmat", None),
                          arr, self.dim_size, self.codim_size)

    def adjoint(self, arr):
        return self._call(self._sp.rmatvec,
                          getattr(self._sp, "rmatmat", None), arr,
                          self.codim_size, self.dim_size)


def from_sciop(sp_op) -> LinOp:
    return _SciOp(sp_op)
