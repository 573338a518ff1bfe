"""Bijections C^sh <-> R^(sh, 2) (counterpart of
``pyxu_tpu/utils/complex.py``).

The public complex-as-real convention of the JAX package: a trailing axis
of size 2 holds (real, imaginary).  ``view_as_real(z)`` of a ``(..., *sh)``
complex tensor is a ``(..., *sh, 2)`` real tensor; ``torch.view_as_real``
and ``torch.view_as_complex`` take exactly this layout, so both directions
are views where the memory allows (``view_as_complex`` copies a tensor
whose trailing pair is not contiguous).
"""

from __future__ import annotations

import torch

__all__ = ["view_as_real", "view_as_complex", "view_as_real_mat",
           "view_as_complex_mat", "real_dtype", "complex_dtype"]

_TO_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_TO_COMPLEX = {
    torch.float32: torch.complex64,
    torch.float64: torch.complex128,
    torch.bfloat16: torch.complex64,    # promote: no complex bf16
    torch.float16: torch.complex64,
}


def real_dtype(cdtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a complex dtype."""
    if cdtype not in _TO_REAL:
        raise ValueError(f"no real counterpart for dtype {cdtype}")
    return _TO_REAL[cdtype]


def complex_dtype(fdtype: torch.dtype) -> torch.dtype:
    """Complex counterpart of a real dtype (bf16 and f16 promote to c64)."""
    if fdtype not in _TO_COMPLEX:
        raise ValueError(f"no complex counterpart for dtype {fdtype}")
    return _TO_COMPLEX[fdtype]


def view_as_real(z: torch.Tensor) -> torch.Tensor:
    """C^sh -> R^(sh, 2)."""
    if not torch.is_complex(z):
        raise ValueError("view_as_real expects a complex tensor")
    return torch.view_as_real(z)


def view_as_complex(x: torch.Tensor) -> torch.Tensor:
    """R^(sh, 2) -> C^sh (f32 -> c64, f64 -> c128; narrower floats are
    promoted to f32 first)."""
    if torch.is_complex(x) or x.ndim == 0 or x.shape[-1] != 2:
        raise ValueError(
            "view_as_complex expects a real tensor with trailing axis 2")
    if x.dtype not in _TO_REAL.values():
        x = x.to(real_dtype(complex_dtype(x.dtype)))
    if (x.stride(-1) != 1 or x.storage_offset() % 2
            or any(s % 2 for s in x.stride()[:-1])):
        x = x.contiguous()
    return torch.view_as_complex(x)


def view_as_real_mat(cmat: torch.Tensor, real_input: bool = False,
                     real_output: bool = False) -> torch.Tensor:
    r"""Real block form of a complex matrix: A in C^{M x N} becomes Ahat in
    R^{2M x 2N} with 2 x 2 blocks [[Re, -Im], [Im, Re]], so that::

        view_as_real(A @ x).ravel()
            == view_as_real_mat(A) @ view_as_real(x).ravel()

    ``real_input`` / ``real_output`` drop the imaginary columns / rows.  A
    real matrix passes through unchanged."""
    if cmat.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {cmat.ndim}-D")
    if not torch.is_complex(cmat):
        return cmat
    M, N = cmat.shape
    re, im = cmat.real, cmat.imag
    blk = torch.stack([torch.stack([re, -im], dim=-1),
                       torch.stack([im, re], dim=-1)], dim=1)  # (M, 2, N, 2)
    rmat = blk.reshape(2 * M, 2 * N)
    if real_input:
        rmat = rmat[:, ::2]
    if real_output:
        rmat = rmat[::2, :]
    return rmat


def view_as_complex_mat(rmat: torch.Tensor, real_input: bool = False,
                        real_output: bool = False) -> torch.Tensor:
    """Inverse of :func:`view_as_real_mat`.  A complex matrix passes
    through unchanged."""
    if rmat.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {rmat.ndim}-D")
    if torch.is_complex(rmat):
        return rmat
    cdt = complex_dtype(rmat.dtype)
    if real_input and real_output:
        return rmat.to(cdt)
    if real_input:          # no imaginary columns: Re and Im on the rows
        return torch.complex(rmat[::2, :], rmat[1::2, :]).to(cdt)
    if real_output:         # no imaginary rows: -Im on the odd columns
        return torch.complex(rmat[:, ::2], -rmat[:, 1::2]).to(cdt)
    return torch.complex(rmat[::2, ::2], rmat[1::2, ::2]).to(cdt)
