"""Builds and loads the port's CUDA kernels.

``nvcc`` compiles ``csrc/traverse_f32.cu`` into a shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library goes to ``build/torch_kernels/`` at the repository
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built or loaded at
import: ``load()`` runs at the first kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "traverse_f32.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# exact IEEE arithmetic (no fast math, no FMA contraction) so that the
# kernel matches its plain PyTorch version bit for bit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"traverse_f32-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_out, out)      # atomic: a concurrent loader sees all or nothing
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log=(proc.stdout + proc.stderr).strip())


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not path.exists():
        _compile(path)
    else:
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(cached build)")
    BUILD_INFO["path"] = str(path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pbrt_trace_stack_cap.argtypes = []
    lib.pbrt_trace_stack_cap.restype = i
    lib.pbrt_trace_error_string.argtypes = [i]
    lib.pbrt_trace_error_string.restype = ctypes.c_char_p
    lib.pbrt_trace_closest_f32.argtypes = [p, p, p, i, p, p, p, i, i,
                                           p, p, p, p, p, p, p]
    lib.pbrt_trace_closest_f32.restype = i
    lib.pbrt_trace_any_f32.argtypes = [p, p, p, i, p, p, p, i, i, p, p, p]
    lib.pbrt_trace_any_f32.restype = i
    _LIB = lib
    return lib
