"""The native binned-SAH builder (``bvh/csrc/bvh_builder.cpp``), through ctypes.

The source is the port's own copy of the JAX package's C++ builder, so
both packages build the same classic BVH (a test pins the tables byte for
byte). ``g++`` compiles it at first use, with the JAX package's flags, into
``build/bvh/`` at the repository root, the library named by a hash of the
source, the flags and the host's CPU model (``-march=native`` ties the
library to the CPU it was built on; an edited source is rebuilt, an
unchanged one reused).
Unlike the JAX package, which falls back silently to its numpy builder, a
failed build raises: the numpy builder gives other tables
(``bvh/builder.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bvh"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_DIR / f"libbvh_builder-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the classic BVH is built by the native "
                           "builder (bvh/csrc/bvh_builder.cpp); pass "
                           "use_native=False for the numpy builder, whose tables "
                           "differ")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / out.name
        proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(part)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(part, out)   # atomic: a concurrent loader sees all or nothing


def get_lib() -> ctypes.CDLL:
    """The builder's library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.bvh_build.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.bvh_emit.restype = ctypes.c_int
        lib.bvh_emit.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = []
        _lib = lib
        return _lib


def build_bvh_native(triangles: np.ndarray, leaf_size: int = 4):
    """(nodes_box (N,12) f32, nodes_child (N,2) i32, tris (P,9) f32,
    prim_index (P,) i32) from the C++ builder; raises where it cannot run."""
    lib = get_lib()
    tri = np.ascontiguousarray(np.asarray(triangles, np.float32).reshape(-1, 9))
    n_nodes = ctypes.c_int64()
    n_prims = ctypes.c_int64()
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    with _lock:   # the library keeps the last build in a global
        rc = lib.bvh_build(fp(tri), ctypes.c_int64(tri.shape[0]),
                           ctypes.c_int(leaf_size), ctypes.byref(n_nodes),
                           ctypes.byref(n_prims))
        if rc != 0:
            raise ValueError(f"native BVH build refused {tri.shape[0]} triangles "
                             f"with leaf_size={leaf_size}")
        nodes_box = np.empty((n_nodes.value, 12), np.float32)
        nodes_child = np.empty((n_nodes.value, 2), np.int32)
        tris_out = np.empty((n_prims.value, 9), np.float32)
        prim_index = np.empty((n_prims.value,), np.int32)
        rc = lib.bvh_emit(fp(nodes_box), ip(nodes_child), fp(tris_out), ip(prim_index))
        lib.bvh_free()
    if rc != 0:
        raise RuntimeError("native BVH emit failed")
    return nodes_box, nodes_child, tris_out, prim_index
