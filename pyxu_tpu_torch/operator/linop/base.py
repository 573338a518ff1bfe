"""Elementary linear operators (counterpart of ``pyxu_tpu/operator/linop/base.py``).

IdentityOp, NullOp, NullFunc, HomothetyOp, DiagonalOp, ExplicitLinOp,
SparseExplicitLinOp and ExplicitLinFunc, with their closed-form
``svdvals``/``trace``/``pinv``/``asarray``.

Where an operator is built from a host array it goes to ``device``,
resolved as every entry point resolves it (``cuda`` unless asked); a
tensor keeps its own device.  Methods that build a result from nothing
(``svdvals``, ``asarray``) take ``dtype`` and ``device`` the same way.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pyxu_tpu_torch.abc.operator import (
    LinFunc,
    LinOp,
    OrthProjOp,
    PosDefOp,
    SelfAdjointOp,
)
from pyxu_tpu_torch.info.dtypes import default_fdtype
from pyxu_tpu_torch.runtime import resolve_device
from pyxu_tpu_torch.utils.misc import as_canonical_shape

__all__ = [
    "IdentityOp",
    "NullOp",
    "NullFunc",
    "HomothetyOp",
    "DiagonalOp",
    "ExplicitLinOp",
    "SparseExplicitLinOp",
    "ExplicitLinFunc",
]


def _eye(op, cst, dtype, device):
    """``cst`` times the identity as a dense ``(*codim, *dim)`` tensor."""
    dt = default_fdtype() if dtype is None else dtype
    eye = torch.eye(op.dim_size, dtype=dt, device=resolve_device(device))
    return (cst * eye).reshape(op.codim_shape + op.dim_shape)


def _tensor(arr, device) -> torch.Tensor:
    """``arr`` as a tensor: a tensor stays where it is (unless ``device`` is
    given); a host array goes to ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return host.to(resolve_device(device))


class IdentityOp(OrthProjOp):
    """x -> x.  Also positive-definite and unitary; kept an ``OrthProjOp``
    as in the JAX package, the strongest class whose API (``gram`` is
    itself, ``pinv`` is ``apply``) fits."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 1.0

    def apply(self, arr):
        return arr

    def adjoint(self, arr):
        return arr

    def svdvals(self, k: int = 1, dtype=None, device=None, **kw):
        return torch.ones(k, dtype=dtype or default_fdtype(),
                          device=resolve_device(device))

    def trace(self, **kw):
        return float(self.dim_size)

    def pinv(self, arr, damp: float = 0.0, **kw):
        return arr / (1.0 + damp)

    def asarray(self, dtype=None, device=None):
        return _eye(self, 1.0, dtype, device)


class NullOp(LinOp):
    """x -> 0."""

    def __init__(self, dim_shape, codim_shape):
        super().__init__(dim_shape, codim_shape)
        self._lipschitz = 0.0

    def apply(self, arr):
        batch = arr.shape[: arr.ndim - self.dim_rank]
        return arr.new_zeros(batch + self.codim_shape)

    def adjoint(self, arr):
        batch = arr.shape[: arr.ndim - self.codim_rank]
        return arr.new_zeros(batch + self.dim_shape)

    def svdvals(self, k: int = 1, dtype=None, device=None, **kw):
        return torch.zeros(k, dtype=dtype or default_fdtype(),
                           device=resolve_device(device))

    def estimate_lipschitz(self, **kw):
        return 0.0

    def asarray(self, dtype=None, device=None):
        return torch.zeros(self.codim_shape + self.dim_shape,
                           dtype=dtype or default_fdtype(),
                           device=resolve_device(device))


class NullFunc(LinFunc):
    """x -> 0 functional."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape)
        self._lipschitz = 0.0

    def apply(self, arr):
        return arr.new_zeros(arr.shape[: arr.ndim - self.dim_rank])

    def adjoint(self, arr):
        return arr.new_zeros(arr.shape + self.dim_shape)

    def grad(self, arr):
        return torch.zeros_like(arr)

    def prox(self, arr, tau):
        return arr

    def estimate_lipschitz(self, **kw):
        return 0.0


class HomothetyOp(SelfAdjointOp):
    """x -> cst * x; a ``PosDefOp`` when cst > 0."""

    def __new__(cls, dim_shape, cst: float):
        if cls is HomothetyOp and float(cst) > 0:
            return object.__new__(_PosDefHomothetyOp)
        return object.__new__(cls)

    def __init__(self, dim_shape, cst: float):
        super().__init__(dim_shape)
        self._cst = float(cst)
        self._lipschitz = abs(self._cst)

    def apply(self, arr):
        return self._cst * arr

    def svdvals(self, k: int = 1, dtype=None, device=None, **kw):
        return torch.full((k,), abs(self._cst),
                          dtype=dtype or default_fdtype(),
                          device=resolve_device(device))

    def trace(self, **kw):
        return self._cst * self.dim_size

    def pinv(self, arr, damp: float = 0.0, **kw):
        return self._cst / (self._cst ** 2 + damp) * arr

    def estimate_lipschitz(self, **kw):
        return abs(self._cst)

    def asarray(self, dtype=None, device=None):
        return _eye(self, self._cst, dtype, device)

    def _expr(self):
        return (f"Homothety[{self._cst}]",)


class _PosDefHomothetyOp(HomothetyOp, PosDefOp):
    pass


class DiagonalOp(SelfAdjointOp):
    """x -> v * x; a ``PosDefOp`` when every v > 0 (one host read of the
    check at construction, as the JAX package probes it)."""

    def __new__(cls, vec, dim_shape=None, enable_warnings: bool = True,
                device=None):
        if cls is DiagonalOp:
            v = _tensor(vec, device)
            if v.numel() and bool((v > 0).all()):
                return object.__new__(_PosDefDiagonalOp)
        return object.__new__(cls)

    def __init__(self, vec, dim_shape=None, enable_warnings: bool = True,
                 device=None):
        vec = _tensor(vec, device)
        dim_shape = tuple(vec.shape) if dim_shape is None else \
            as_canonical_shape(dim_shape)
        super().__init__(dim_shape)
        self._vec = vec.broadcast_to(dim_shape)
        self._name = "DiagonalOp"

    def apply(self, arr):
        return self._vec * arr

    def svdvals(self, k: int = 1, **kw):
        """The top-k magnitudes, ascending."""
        return torch.sort(torch.abs(self._vec).reshape(-1)).values[-k:]

    def trace(self, **kw):
        return float(torch.sum(self._vec))

    def estimate_lipschitz(self, **kw):
        self._lipschitz = float(torch.max(torch.abs(self._vec)))
        return self._lipschitz

    def pinv(self, arr, damp: float = 0.0, **kw):
        scale = self._vec / (self._vec ** 2 + damp)
        scale = torch.where(torch.isfinite(scale), scale, 0.0)
        return scale * arr

    def asarray(self, dtype=None, device=None):
        v = self._vec.reshape(-1)
        v = v.to(dtype=dtype or default_fdtype(), device=device or v.device)
        return torch.diag(v).reshape(self.codim_shape + self.dim_shape)


class _PosDefDiagonalOp(DiagonalOp, PosDefOp):
    pass


def _is_sparse(obj) -> bool:
    """True for scipy.sparse matrices and sparse torch tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.layout != torch.strided
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(obj)


class ExplicitLinOp(LinOp):
    """Dense-matrix operator: ``mat`` has shape ``(*codim_shape,
    *dim_shape)`` with ``dim_rank`` trailing domain axes; apply and adjoint
    are one matmul on the flattened matrix, in the input's dtype."""

    def __init__(self, mat, dim_rank: int = 1, device=None):
        if _is_sparse(mat):
            raise TypeError("ExplicitLinOp is dense-only: use "
                            "SparseExplicitLinOp (or LinOp.from_array, "
                            "which dispatches on the layout)")
        mat = _tensor(mat, device)
        super().__init__(tuple(mat.shape[mat.ndim - dim_rank:]),
                         tuple(mat.shape[: mat.ndim - dim_rank]))
        self._mat = mat
        self._name = "ExplicitLinOp"

    def _M(self, like):
        return self._mat.reshape(self.codim_size, self.dim_size).to(
            like.dtype)

    def apply(self, arr):
        batch = arr.shape[: arr.ndim - self.dim_rank]
        x = arr.reshape(batch + (self.dim_size,))
        return (x @ self._M(arr).T).reshape(batch + self.codim_shape)

    def adjoint(self, arr):
        batch = arr.shape[: arr.ndim - self.codim_rank]
        y = arr.reshape(batch + (self.codim_size,))
        return (y @ self._M(arr)).reshape(batch + self.dim_shape)

    def asarray(self, dtype=None, device=None):
        return self._mat.to(dtype=dtype or self._mat.dtype,
                            device=device or self._mat.device)

    def trace(self, **kw):
        assert self.dim_size == self.codim_size
        return float(torch.trace(self._mat.reshape(self.dim_size,
                                                   self.dim_size)))

    def estimate_lipschitz(self, method: str = "svd", **kw):
        M = self._mat.reshape(self.codim_size, self.dim_size)
        if method in ("svd", "power"):
            self._lipschitz = float(torch.linalg.matrix_norm(M, ord=2))
        else:
            self._lipschitz = float(torch.linalg.matrix_norm(M))
        return self._lipschitz

    def svdvals(self, k: int = 1, **kw):
        """The top-k singular values, ascending."""
        M = self._mat.reshape(self.codim_size, self.dim_size)
        return torch.flip(torch.linalg.svdvals(M)[:k], (0,))


class SparseExplicitLinOp(LinOp):
    """Sparse-matrix operator on torch's CSR layout.

    ``mat`` is a ``scipy.sparse`` matrix or a 2-D torch sparse tensor (any
    sparse layout) of shape ``(codim_size, dim_size)``; ``dim_shape`` and
    ``codim_shape`` default to its columns and rows.  The matrix and its
    transpose are both kept in CSR, so ``apply`` and ``adjoint`` are each
    one sparse-times-dense product over the flattened batch (cuSPARSE on
    the card).  Floating scipy data takes the current default width; a
    torch tensor keeps its dtype and device, scipy data goes to ``device``.
    Complex data, a hybrid or non-2-D layout raise ``TypeError``: complex
    operators are pairs of real ones over the ``(..., 2)`` views.
    """

    def __init__(self, mat, dim_rank: int = 1, dim_shape=None,
                 codim_shape=None, device=None):
        if isinstance(mat, torch.Tensor):
            if mat.layout == torch.strided:
                raise TypeError("a dense tensor: use ExplicitLinOp")
            if mat.ndim != 2 or mat.dense_dim() != 0:
                raise TypeError(
                    f"a sparse matrix must be 2-D with scalar entries, got "
                    f"shape {tuple(mat.shape)} with {mat.dense_dim()} dense "
                    "dimensions")
            if mat.is_complex():
                raise TypeError(_COMPLEX_SPARSE)
            csr = mat.to_sparse_csr()
            if device is not None:
                csr = csr.to(device)
        else:
            try:
                import scipy.sparse as sp
            except ImportError:  # pragma: no cover
                sp = None
            if sp is None or not sp.issparse(mat):
                raise TypeError(
                    f"expected a scipy.sparse matrix or a torch sparse "
                    f"tensor, got {type(mat).__name__} (dense arrays: "
                    "ExplicitLinOp)")
            m = sp.csr_matrix(mat)
            if np.iscomplexobj(m.data):
                raise TypeError(_COMPLEX_SPARSE)
            m.sum_duplicates()
            if m.data.dtype.kind == "f":
                m = m.astype(torch.empty(0, dtype=default_fdtype())
                             .numpy().dtype)
            with warnings.catch_warnings():     # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(
                    torch.from_numpy(m.indptr.astype(np.int64)),
                    torch.from_numpy(m.indices.astype(np.int64)),
                    torch.from_numpy(m.data), size=m.shape,
                    check_invariants=True).to(resolve_device(device))
        full = tuple(csr.shape)
        if dim_shape is None:
            dim_shape = full[2 - dim_rank:]
        if codim_shape is None:
            codim_shape = full[:2 - dim_rank]
        super().__init__(as_canonical_shape(dim_shape),
                         as_canonical_shape(codim_shape))
        if full != (self.codim_size, self.dim_size):
            raise TypeError(f"matrix {full} for an operator of "
                            f"{self.codim_shape} x {self.dim_shape}")
        self._mat = csr
        self._matT = csr.t().to_sparse_csr()
        self._cast = {}         # (dtype, transposed) -> matrix in dtype
        self._name = "SparseExplicitLinOp"

    def _M(self, like, transposed: bool):
        key = (like.dtype, transposed)
        if key not in self._cast:
            m = self._matT if transposed else self._mat
            self._cast[key] = m if m.dtype == like.dtype else m.to(like.dtype)
        return self._cast[key]

    def _smv(self, arr, rank, n, out_shape, transposed):
        batch = arr.shape[: arr.ndim - rank]
        x = arr.reshape((-1, n)).T                      # (n, B)
        y = self._M(arr, transposed) @ x.contiguous()   # (m, B)
        return y.T.reshape(batch + out_shape)

    def apply(self, arr):
        return self._smv(arr, self.dim_rank, self.dim_size,
                         self.codim_shape, False)

    def adjoint(self, arr):
        return self._smv(arr, self.codim_rank, self.codim_size,
                         self.dim_shape, True)

    def asarray(self, dtype=None, device=None):
        dense = self._mat.to_dense().reshape(self.codim_shape
                                             + self.dim_shape)
        return dense.to(dtype=dtype or dense.dtype,
                        device=device or dense.device)

    def trace(self, **kw):
        assert self.dim_size == self.codim_size
        crow = self._mat.crow_indices().cpu().numpy()
        col = self._mat.col_indices().cpu().numpy()
        val = self._mat.values().cpu().numpy()
        row = np.repeat(np.arange(len(crow) - 1), np.diff(crow))
        return float(val[row == col].sum())


_COMPLEX_SPARSE = ("complex sparse matrices are not supported: use the "
                   "real (..., 2) view convention (utils.complex) and two "
                   "real operators")


class ExplicitLinFunc(LinFunc):
    """f(x) = <w, x> from an explicit vector (kept on its own device)."""

    def __init__(self, vec: torch.Tensor):
        super().__init__(tuple(vec.shape))
        self._vec = vec
        self._name = "ExplicitLinFunc"

    def _w(self, like):
        return self._vec.to(dtype=like.dtype)

    def apply(self, arr):
        return torch.sum(arr * self._w(arr),
                         dim=tuple(range(-self.dim_rank, 0)))

    def adjoint(self, arr):
        return arr.reshape(arr.shape + (1,) * self.dim_rank) * self._w(arr)


#: The dense-matrix operator under the name downstream code uses.
_ExplicitLinOp = ExplicitLinOp
