"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` at first use into ``csrc/_build/`` (git-ignored), under a name
keyed by a hash of the source and the flags, then loaded with ``ctypes``.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["compile_and_load"]

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = _CSRC / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def compile_and_load(source: str, defines: tuple = ()):
    """Compile ``csrc/<source>`` (once per source hash and ``defines``, the
    macros passed as ``-D``) and load it.

    Returns ``(ctypes.CDLL, compiler output)``; the output is empty when the
    library was already built.  A failed build raises with nvcc's output.
    """
    path = _CSRC / source
    src = path.read_bytes()
    flags = _NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    so = _BUILD_DIR / f"{path.stem}_{digest[:16]}.so"
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(path)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):"
                               f"\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log
