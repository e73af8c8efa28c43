"""The native builders, through ctypes: the binned-SAH builder
(``bvh/csrc/bvh_builder.cpp``) and the spatial-split SBVH builder
(``bvh/csrc/sbvh_builder.cpp``, the BuildHQ analogue).

The sources are the port's own copies of the JAX package's C++ builders,
so both packages build the same trees (tests pin the tables byte for
byte). ``g++`` compiles each at first use, with the JAX package's flags,
into ``build/bvh/`` at the repository root, each library named by a hash of
its source, the flags and the host's CPU model (``-march=native`` ties the
library to the CPU it was built on; an edited source is rebuilt, an
unchanged one reused).
Unlike the JAX package, which falls back silently where a library cannot be
built (the classic build to its numpy builder, the SBVH builds to the
binned cores or None), a failed build raises: the fallbacks give other
tables (``bvh/builder.py``, ``bvh/dense.py``).
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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"bvh_builder": _CSRC / "bvh_builder.cpp",
           "sbvh_builder": _CSRC / "sbvh_builder.cpp"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bvh"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
# each library's C functions: (restype, argtypes)
_SIGNATURES = {
    "bvh_builder": {
        "bvh_build": (ctypes.c_int, [_F, ctypes.c_int64, ctypes.c_int, _I64, _I64]),
        "bvh_emit": (ctypes.c_int, [_F, _I32, _F, _I32]),
        "bvh_free": (None, []),
    },
    "sbvh_builder": {
        "sbvh_build": (ctypes.c_int, [_F, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                      _I64, _I64, _I64]),
        "sbvh_emit": (ctypes.c_int, [_F, _I32, _I64, _I32]),
        "sbvh_free": (None, []),
    },
}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path(name: str = "bvh_builder") -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    src = SOURCES[name]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: bvh/csrc/{src.name} is built with it "
                           "(the classic BVH's numpy builder, use_native=False, gives "
                           "other tables; the SBVH builds have no other builder)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / out.name
        proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(part)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(part, out)   # atomic: a concurrent loader sees all or nothing


def _get(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _build(name, path)
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib


def get_lib() -> ctypes.CDLL:
    """The binned-SAH builder's library, compiled on first use."""
    return _get("bvh_builder")


def get_sbvh_lib() -> ctypes.CDLL:
    """The SBVH builder's library, compiled on first use."""
    return _get("sbvh_builder")


def _fp(a):
    return a.ctypes.data_as(_F)


def _ip(a):
    return a.ctypes.data_as(_I32)


def build_bvh_native(triangles: np.ndarray, leaf_size: int = 4):
    """(nodes_box (N,12) f32, nodes_child (N,2) i32, tris (P,9) f32,
    prim_index (P,) i32) from the C++ builder; raises where it cannot run."""
    lib = get_lib()
    tri = np.ascontiguousarray(np.asarray(triangles, np.float32).reshape(-1, 9))
    n_nodes = ctypes.c_int64()
    n_prims = ctypes.c_int64()
    with _lock:   # the library keeps the last build in a global
        rc = lib.bvh_build(_fp(tri), ctypes.c_int64(tri.shape[0]),
                           ctypes.c_int(leaf_size), ctypes.byref(n_nodes),
                           ctypes.byref(n_prims))
        if rc != 0:
            raise ValueError(f"native BVH build refused {tri.shape[0]} triangles "
                             f"with leaf_size={leaf_size}")
        nodes_box = np.empty((n_nodes.value, 12), np.float32)
        nodes_child = np.empty((n_nodes.value, 2), np.int32)
        tris_out = np.empty((n_prims.value, 9), np.float32)
        prim_index = np.empty((n_prims.value,), np.int32)
        rc = lib.bvh_emit(_fp(nodes_box), _ip(nodes_child), _fp(tris_out), _ip(prim_index))
        lib.bvh_free()
    if rc != 0:
        raise RuntimeError("native BVH emit failed")
    return nodes_box, nodes_child, tris_out, prim_index


def build_sbvh_generic(triangles: np.ndarray, leaf_size: int, dense_mode: bool):
    """Spatial-split SBVH build (BuildHQ analogue, csrc/sbvh_builder.cpp).

    Returns (nodes_box (N,12) f32, children (N,2) i32, segments:
    list[np.ndarray of prim ids]); raises where the builder cannot run.
    children codes: >=0 internal node, INT32_MIN absent, other <0 leaf with
    segment = -(c+1). Leaf segments may reference the same primitive from
    sibling subtrees (spatial-split duplication).
    """
    lib = get_sbvh_lib()
    tri = np.ascontiguousarray(np.asarray(triangles, np.float32).reshape(-1, 9))
    n_nodes = ctypes.c_int64()
    n_segs = ctypes.c_int64()
    n_refs = ctypes.c_int64()
    with _lock:   # the library keeps the last build in a global
        rc = lib.sbvh_build(_fp(tri), ctypes.c_int64(tri.shape[0]),
                            ctypes.c_int(leaf_size), ctypes.c_int(1 if dense_mode else 0),
                            ctypes.byref(n_nodes), ctypes.byref(n_segs),
                            ctypes.byref(n_refs))
        if rc != 0:
            raise ValueError(f"native SBVH build refused {tri.shape[0]} triangles "
                             f"with leaf_size={leaf_size}")
        nodes_box = np.empty((n_nodes.value, 12), np.float32)
        children = np.empty((n_nodes.value, 2), np.int32)
        seg_off = np.empty((n_segs.value + 1,), np.int64)
        refs = np.empty((max(n_refs.value, 1),), np.int32)
        rc = lib.sbvh_emit(_fp(nodes_box), _ip(children), seg_off.ctypes.data_as(_I64),
                           _ip(refs))
        lib.sbvh_free()
    if rc != 0:
        raise RuntimeError("native SBVH emit failed")
    segments = [refs[seg_off[s]:seg_off[s + 1]].copy() for s in range(n_segs.value)]
    return nodes_box, children, segments
