"""Versioned BVH save/load cache; counterpart of ``physically_based_ray_tracer_tpu/bvh/cache.py``.

A built tree persists as an ``.npz`` with a version header, a layout tag
and a content hash of its source triangles and build options; a missing,
stale or layout-incompatible cache loads as None and the caller rebuilds.
The keys, ``FORMAT_VERSION``, layouts and hash are the JAX package's, so a
cache written by either package loads in the other. Only the tables the
JAX package stores are written: the classic BVH's Woop rows and the dense
table's derived tables (``leaf_rec``, ``groups_bf2``) and ``stack_need``
are rebuilt on load, on ``device``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import DenseBVH
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

FORMAT_VERSION = 3   # v3: + compact winner-decode prim table (pids_c);
#      v2 added groups_bf/glo; older caches load as None


def _norm(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; normalise so that
    save and load agree on the name on disk."""
    return path if path.endswith(".npz") else path + ".npz"


def _tri_hash(triangles: np.ndarray, extra: str = "") -> str:
    tri = np.ascontiguousarray(np.asarray(triangles, np.float32))
    h = hashlib.sha256()
    h.update(tri.tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:32]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_bvh(path: str, bvh: BVHArrays, triangles=None, params: str = ""):
    """Persist a classic 2-wide BVH. ``triangles``/``params`` bind the cache
    to its source geometry and build options."""
    np.savez_compressed(
        _norm(path),
        version=np.int64(FORMAT_VERSION), layout="bvh2",
        content=_tri_hash(triangles, params) if triangles is not None else "",
        nodes_box=_np(bvh.nodes_box), nodes_child=_np(bvh.nodes_child),
        tris=_np(bvh.tris), prim_index=_np(bvh.prim_index))


def _open(path: str, layout: str, triangles, params: str):
    """The archive at ``path`` if it holds this version and layout (and,
    given ``triangles``, their hash), else None."""
    path = _norm(path)
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION or str(z["layout"]) != layout:
        return None
    if triangles is not None and str(z["content"]) != _tri_hash(triangles, params):
        return None
    return z


def load_bvh(path: str, triangles=None, params: str = "",
             device=DEFAULT_DEVICE) -> BVHArrays | None:
    """Load a cached classic BVH onto ``device``; None when missing,
    version-mismatched, or built from other geometry or options."""
    device = resolve(device)
    try:
        z = _open(path, "bvh2", triangles, params)
        if z is None:
            return None
        return BVHArrays.from_numpy(z["nodes_box"], z["nodes_child"], z["tris"],
                                    z["prim_index"], device=device)
    except (OSError, KeyError, ValueError):
        return None


def save_dense(path: str, dbvh: DenseBVH, triangles=None, params: str = ""):
    """Persist a dense-leaf BVH table (its bf16 leaves as their 16-bit
    patterns, as the JAX package stores them)."""
    np.savez_compressed(
        _norm(path),
        version=np.int64(FORMAT_VERSION), layout="dense",
        content=_tri_hash(triangles, params) if triangles is not None else "",
        nodes16=_np(dbvh.nodes16), groups=_np(dbvh.groups),
        inst16=_np(dbvh.inst16), prim_base=_np(dbvh.prim_base),
        world_lo=_np(dbvh.world_lo), world_hi=_np(dbvh.world_hi),
        groups_bf=_np(dbvh.groups_bf.view(torch.int16)).view(np.uint16),
        glo=_np(dbvh.glo), pids_c=_np(dbvh.pids_c))


def load_dense(path: str, triangles=None, params: str = "",
               device=DEFAULT_DEVICE) -> DenseBVH | None:
    """Load a cached dense table onto ``device`` (its derived tables and
    stack need built there from the loaded ones); None as ``load_bvh``."""
    device = resolve(device)
    try:
        z = _open(path, "dense", triangles, params)
        if z is None:
            return None
        return DenseBVH.from_numpy(*(z[k] for k in ("nodes16", "groups", "inst16",
                                                    "prim_base", "world_lo", "world_hi")),
                                   groups_bf=z["groups_bf"], glo=z["glo"],
                                   pids_c=z["pids_c"], device=device)
    except (OSError, KeyError, ValueError):
        return None


def cached_build_bvh(cache_path: str, triangles, builder, params: str = "",
                     device=DEFAULT_DEVICE):
    """Load-or-build-and-save. ``builder(triangles) -> BVHArrays``. Returns
    (the tree on ``device``, whether it came from the cache)."""
    hit = load_bvh(cache_path, triangles, params, device=device)
    if hit is not None:
        return hit, True
    bvh = builder(triangles)
    save_bvh(cache_path, bvh, triangles, params)
    return bvh.to(resolve(device)), False
