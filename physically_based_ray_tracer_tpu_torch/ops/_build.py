"""Builds and loads the port's CUDA kernels.

``nvcc`` compiles each source of ``csrc/`` (``traverse_f32.cu``, kernel B1;
``traverse_bf16.cu``, kernel B2; ``traverse_rows.cu``, kernel B3;
``leaf_mt.cu``, kernel B4; ``wave_scan.cu``, the wave engine's node scan;
``wave_level.cu``, the wave engine's fused cascade level; ``take_rows.cu``,
the backward of the row gather ``ops/take_rows.py``)
into a shared library of its own with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The libraries go to ``build/torch_kernels/`` at the
repository root, each named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built or loaded at import: the first
``load()`` builds every missing library at once, one ``nvcc`` per source,
all started together.
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
CSRC = _PKG / "csrc"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("traverse_f32", "traverse_bf16", "traverse_rows", "leaf_mt",
                        "wave_scan", "wave_level", "take_rows")}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# exact IEEE arithmetic (no fast math, no FMA contraction) so that the
# kernels match their plain PyTorch versions bit for bit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (argtypes, restype)
_SIGNATURES = {
    "traverse_f32": {
        "pbrt_trace_stack_cap": ([], _i),
        "pbrt_trace_error_string": ([_i], ctypes.c_char_p),
        "pbrt_trace_closest_f32": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i,
                                    _p, _p, _p, _p, _p, _p, _p], _i),
        "pbrt_trace_any_f32": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i,
                                _p, _p, _p], _i),
        "pbrt_trace_count_f32": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i, _i,
                                  _p, _p, _p, _p, _p, _p, _p, _p, _p], _i),
    },
    "traverse_bf16": {
        "pbrt_trace_bf16_stack_cap": ([], _i),
        "pbrt_trace_bf16_error_string": ([_i], ctypes.c_char_p),
        "pbrt_trace_closest_bf16": ([_p, _p, _p, _p, _i, _p, _p, _p, _i, _i,
                                     _p, _p, _p, _p, _p], _i),
        "pbrt_trace_any_bf16": ([_p, _p, _p, _p, _i, _p, _p, _p, _i, _i,
                                 _p, _p, _p, _p], _i),
        "pbrt_trace_count_bf16": ([_p, _p, _p, _p, _i, _p, _p, _p, _i, _i, _i,
                                   _p, _p, _p, _p, _p, _p, _p, _p], _i),
        "pbrt_bf16x2_check": ([_p, _p], _i),
    },
    "traverse_rows": {
        "pbrt_trace_rows_stack_cap": ([], _i),
        "pbrt_trace_rows_error_string": ([_i], ctypes.c_char_p),
        "pbrt_trace_closest_rows": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i,
                                     _p, _p, _p, _p, _p, _p, _p], _i),
        "pbrt_trace_any_rows": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i,
                                 _p, _p, _p], _i),
        "pbrt_trace_count_rows": ([_p, _p, _i, _p, _i, _p, _p, _p, _i, _i, _i,
                                   _p, _p, _p, _p, _p, _p, _p, _p, _p], _i),
        "pbrt_rows_order_keys": ([_p, _p, _i, _p], _i),
    },
    "leaf_mt": {
        "pbrt_leaf_mt_error_string": ([_i], ctypes.c_char_p),
        "pbrt_leaf_mt_closest": ([_p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                                  _i, _i, _i, _i, _i, _p], _i),
        "pbrt_leaf_mt_any": ([_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p], _i),
    },
    "wave_scan": {
        "pbrt_wave_scan_error_string": ([_i], ctypes.c_char_p),
        "pbrt_wave_scan": ([_p, _p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p, _p, _p,
                            _i, _i, _i, _i, _p, _p], _i),
    },
    "wave_level": {
        "pbrt_wave_level_error_string": ([_i], ctypes.c_char_p),
        "pbrt_wave_level_threads": ([], _i),
        "pbrt_wave_level": ([_p, _p, _i, *[_p] * 18, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                             _p, _p, _p, _i, _p, _p, _p], _i),
    },
    "take_rows": {
        "pbrt_take_rows_error_string": ([_i], ctypes.c_char_p),
        "pbrt_take_rows_tile": ([], _i),
        "pbrt_take_rows_backward": ([_p, _p, _p, _p, _p, _i, _i, _p], _i),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# per library: path, build seconds, nvcc's output (ptxas register counts)
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Build every library that is missing, one nvcc per source, in parallel."""
    todo = {name: library_path(name) for name in SOURCES}
    todo = {name: out for name, out in todo.items() if not out.exists()}
    for name in SOURCES:
        if name not in todo:
            BUILD_INFO.setdefault(name, dict(path=str(library_path(name)),
                                             seconds=0.0, log="(cached build)"))
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(Path(tmp) / out.name), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, out in todo.items()}
        failed = []
        for name, proc in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO[name] = dict(path=str(todo[name]), log=log.strip(),
                                    seconds=time.perf_counter() - t0)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {SOURCES[name].name} "
                              f"({proc.returncode}):\n{log}")
                continue
            # atomic: a concurrent loader sees all or nothing
            os.replace(Path(tmp) / todo[name].name, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library of kernel source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = bind(ctypes.CDLL(str(library_path(name))), name)
    _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Sets the argument and result types of library ``name``'s entry points
    on ``lib`` (also a library built from a variant of its source)."""
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
