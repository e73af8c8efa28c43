"""Wavefront OBJ/MTL loader producing fat arrays; counterpart of
``physically_based_ray_tracer_tpu/models/obj.py``, a line-for-line numpy copy.

De-indexed per-corner positions/normals/UVs + face normals, one MeshModel
per material (``usemtl`` group), smooth normals generated when the file has
none, and the v-flip of UVs that the reference's importer applies.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from physically_based_ray_tracer_tpu_torch.models import textures as tex
from physically_based_ray_tracer_tpu_torch.scene.scene import MeshModel


def _parse_mtl(path: str) -> dict:
    """name -> dict of material properties (Kd/Ke/Ns/map_Kd/...)."""
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            k = parts[0]
            if k == "newmtl":
                cur = {}
                mats[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is None:
                continue
            elif k in ("Kd", "Ke"):
                cur[k] = tuple(float(x) for x in parts[1:4])
            elif k in ("Ns", "d", "Ni", "Pm", "Pr"):
                cur[k] = float(parts[1])
            elif k in ("map_Kd", "map_Bump", "bump", "norm", "map_Pm",
                       "map_Pr", "map_Ke"):
                cur[k] = parts[-1]
    return mats


def _smooth_normals(corner: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals over positionally-merged vertices
    (aiProcess_GenSmoothNormals analogue, Core/Model.cpp:167)."""
    t = corner.reshape(-1, 3, 3)
    fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])  # area-weighted
    uniq, inv = np.unique(corner.round(decimals=5), axis=0,
                          return_inverse=True)
    acc = np.zeros((len(uniq), 3), np.float64)
    np.add.at(acc, inv, np.repeat(fn, 3, axis=0))
    n = acc[inv]
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(ln > 1e-20, n / np.maximum(ln, 1e-20),
                 np.repeat(fn / np.maximum(
                     np.linalg.norm(fn, axis=1, keepdims=True), 1e-20),
                     3, axis=0))
    return n.astype(np.float32)


def load_obj(path: str, name: str | None = None) -> list[MeshModel]:
    """Load an OBJ file; returns one MeshModel per material group."""
    stem = name or os.path.splitext(os.path.basename(path))[0]
    base_dir = os.path.dirname(path)
    vs: list = []
    vts: list = []
    vns: list = []
    mtl: dict = {}
    groups: dict = {}
    order: list = []
    cur_mat = None

    def corner_of(tok):
        w = tok.split("/")
        vi = int(w[0])
        ti = int(w[1]) if len(w) > 1 and w[1] else 0
        ni = int(w[2]) if len(w) > 2 and w[2] else 0
        return vi, ti, ni

    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            k = parts[0]
            if k == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif k == "vt":
                vts.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif k == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif k == "mtllib":
                mtl.update(_parse_mtl(os.path.join(base_dir, " ".join(parts[1:]))))
            elif k == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else None
            elif k == "f":
                if cur_mat not in groups:
                    groups[cur_mat] = []
                    order.append(cur_mat)
                cs = [corner_of(t) for t in parts[1:]]
                for i in range(1, len(cs) - 1):   # fan-triangulate
                    groups[cur_mat].append((cs[0], cs[i], cs[i + 1]))

    v = np.asarray(vs, np.float32) if vs else np.zeros((0, 3), np.float32)
    vt = np.asarray(vts, np.float32) if vts else np.zeros((0, 2), np.float32)
    vn = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)

    def resolve(idx, n):
        # OBJ indices are 1-based; negative = relative to end
        i = np.asarray(idx, np.int64)
        return np.where(i > 0, i - 1, np.where(i < 0, n + i, 0))

    out = []
    for key in order:
        tris = groups[key]
        if not tris:
            continue
        flat = np.asarray(tris, np.int64).reshape(-1, 3)   # (3T, [v,t,n])
        ci = resolve(flat[:, 0], len(v))
        ti = resolve(flat[:, 1], len(vt))
        ni = resolve(flat[:, 2], len(vn))
        corner = v[np.clip(ci, 0, max(len(v) - 1, 0))]
        has_uv = flat[:, 1] != 0
        uv = np.where(has_uv[:, None],
                      vt[np.clip(ti, 0, max(len(vt) - 1, 0))]
                      if len(vt) else np.zeros((len(flat), 2), np.float32),
                      0.0).astype(np.float32)
        uv[:, 1] = np.where(has_uv, 1.0 - uv[:, 1], 0.0)   # aiProcess_FlipUVs
        has_n = flat[:, 2] != 0
        if len(vn) and has_n.all():
            normal = vn[np.clip(ni, 0, len(vn) - 1)]
        else:
            normal = _smooth_normals(corner)
        t = corner.reshape(-1, 3, 3)
        fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)

        m = mtl.get(key, {})
        base_color = tuple(m.get("Kd", (0.8, 0.8, 0.8)))
        emissive = tuple(m.get("Ke", (0.0, 0.0, 0.0)))
        # Ns (0..1000 specular exponent) -> roughness; PBR extensions win
        rough = m.get("Pr", float(np.clip(
            1.0 - np.sqrt(m.get("Ns", 250.0)) / np.sqrt(1000.0), 0.04, 1.0)))
        metal = m.get("Pm", 0.0)
        albedo = (tex.load_texture(os.path.join(base_dir, m["map_Kd"]))
                  if "map_Kd" in m else None)
        nrm_map = None
        for nk in ("norm", "map_Bump", "bump"):
            if nk in m:
                nrm_map = tex.load_texture(os.path.join(base_dir, m[nk]))
                break
        out.append(MeshModel(
            corners=corner.astype(np.float32), normals=normal.astype(np.float32),
            uvs=uv, face_normals=fn.astype(np.float32),
            name=stem if len(order) == 1 else f"{stem}.{key}",
            base_color=base_color, metalness=float(metal),
            roughness=float(rough), emissive=emissive,
            albedo_texture=albedo, normal_texture=nrm_map))
    return out


def load_model(path: str, name: str | None = None) -> list[MeshModel]:
    """Format dispatcher (Model::Load analogue): one call for any supported
    model file; returns one MeshModel per material."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        from physically_based_ray_tracer_tpu_torch.models.gltf import load_gltf_multi
        return load_gltf_multi(path, name=name)
    if ext == ".obj":
        return load_obj(path, name=name)
    raise ValueError(f"unsupported model format: {ext} "
                     "(supported: .gltf, .glb, .obj)")
