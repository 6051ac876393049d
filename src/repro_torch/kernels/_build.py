"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library of its
own with a plain C interface, loaded with ``ctypes``: pointers and the
stream go as ``c_void_p``, sizes as ``c_int``/``c_longlong``, and each C
function returns ``cudaGetLastError()``, which the wrappers raise on.
``flash_decode.cu`` builds twice, its f32 and its bf16 instantiations
each a library of their own (``VARIANTS``: one define each), so that its
100 instantiations compile on two cores.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for every one;
ptxas's report of each (``-Xptxas -v`` where ``EXTRA_FLAGS`` asks for it)
stays in :data:`LOGS`.  The libraries land in ``build/repro_torch_kernels/``
at the repository root, named by a hash of their source and the flags, so
an edited source rebuilds and an unchanged one loads the existing file.

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

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points of each source: name -> argtypes (every restype is int).
# Each ``*_smem`` reports one instantiation's static and dynamic shared
# memory (``kernel_smem``)
ENTRY_POINTS = {
    "nm_spmm": {
        "repro_nm_matmul_expert": [_P] * 6 + [_I] * 9 + [_P],
        "repro_nm_matmul_smem": [_I] * 3 + [_PI] * 2,
    },
    "nm_mask24": {
        "repro_nm_mask24": [_P, _P, _LL, _I, _I, _P],
        "repro_nm_mask24_smem": [_I] + [_PI] * 2,
    },
    "prox24": {
        "repro_prox24": [_P, _P, _LL, _I, _I, _F, _F, _F, _I, _P],
        "repro_prox24_smem": [_I] + [_PI] * 2,
    },
    "saliency_fuse": {
        "repro_saliency_fused_step": [_P] * 9 + [_LL] + [_I] * 4
                                     + [_F, _F, _P],
        "repro_saliency_fused_step_smem": [_I] * 3 + [_PI] * 2,
    },
    **{f"flash_decode_{dt}": {
        "repro_flash_decode": [_P] * 8 + [_I] * 9 + [_F, _P],
        "repro_flash_decode_combine": [_P] * 4 + [_I] * 5 + [_P],
        "repro_flash_decode_smem": [_I] * 4 + [_PI] * 2,
        "repro_flash_decode_combine_smem": [_I] + [_PI] * 2,
    } for dt in ("f32", "bf16")},
}
# libraries built from another library's source with a define:
# name -> (source, flags)
VARIANTS = {f"flash_decode_{dt}": ("flash_decode",
                                   (f"-DREPRO_FD_ONLY={code}",))
            for dt, code in (("f32", 0), ("bf16", 1))}
# flags of one library on top of NVCC_FLAGS: the elementwise search passes
# round every op on its own, as their plain PyTorch versions do; the
# decode attention kernels report their registers and spills
EXTRA_FLAGS = {"prox24": ("-fmad=false",), "saliency_fuse": ("-fmad=false",),
               **{name: ("-Xptxas", "-v") for name in VARIANTS}}
# nvcc's output (ptxas's report) of each library built by this process
LOGS: dict[str, str] = {}


def _source(name: str) -> pathlib.Path:
    return CSRC / f"{VARIANTS.get(name, (name, ()))[0]}.cu"


def _flags(name: str) -> tuple[str, ...]:
    return (NVCC_FLAGS + VARIANTS.get(name, (name, ()))[1]
            + EXTRA_FLAGS.get(name, ()))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of repro_torch cannot be built")
    return found


def _so_path(name: str) -> pathlib.Path:
    src = _source(name)
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> None:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` each, started together; raise if any of them fails."""
    names = list(ENTRY_POINTS) if names is None else list(names)
    todo = [(n, _so_path(n)) for n in names if not _so_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(_source(name))]
        running.append((cmd, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for (name, _), (cmd, so, tmp, proc) in zip(todo, running, strict=True):
        out, _ = proc.communicate()
        LOGS[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    build([name])
    lib = ctypes.CDLL(str(_so_path(name)))
    for fn, argtypes in ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    return lib


def kernel_smem(name: str, fn: str, *selectors: int) -> tuple[int, int]:
    """(static, dynamic) shared-memory bytes of the instantiation that the
    launch entry ``fn`` of library ``name`` picks for ``selectors`` (the
    ``*_smem`` entry points: ``cudaFuncGetAttributes``' static size and
    the dynamic size the launch passes).  Needs the card."""
    st, dyn = ctypes.c_int(-1), ctypes.c_int(-1)
    err = getattr(library(name), fn)(*selectors, ctypes.byref(st),
                                     ctypes.byref(dyn))
    if err:
        raise RuntimeError(f"{fn}{selectors}: CUDA error {err}")
    return st.value, dyn.value
