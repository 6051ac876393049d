"""Build the CUDA kernels under ``csrc/`` at first use and load them.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``: pointers
and the stream go as ``c_void_p``, sizes as ``c_int``/``c_longlong``, and
each C function returns ``cudaGetLastError()``, which the wrappers raise on.
The library lands in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing file.

Nothing here runs at import: a machine without the CUDA toolkit, where the
CPU tests run, has no ``nvcc``, and only a wrapper handed a CUDA tensor
calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of repro_torch cannot be built")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_nm_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.repro_nm_matmul.restype = i
    lib.repro_nm_mask24.argtypes = [p, p, ll, i, i, p]
    lib.repro_nm_mask24.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return _declare(ctypes.CDLL(str(so)))
