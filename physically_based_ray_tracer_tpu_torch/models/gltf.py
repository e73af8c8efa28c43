"""Pure-python glTF 2.0 / GLB loader producing fat arrays; counterpart of
``physically_based_ray_tracer_tpu/models/gltf.py``, a line-for-line numpy copy.

De-indexed per-corner positions/normals/UVs plus face normals, with the
reference importer's UV v-flip. Textures resolve in order: the naming
convention ``<ModelName>_<type><ext>`` next to the model file, then the
images the glTF material references, then the material's constant factors.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct

import numpy as np

from physically_based_ray_tracer_tpu_torch.models import textures as tex
from physically_based_ray_tracer_tpu_torch.scene.scene import MeshModel

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_glb(path: str):
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path}: not a GLB file")
        gltf = None
        buffers = []
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            clen, ctype = struct.unpack("<II", header)
            data = f.read(clen)
            if ctype == 0x4E4F534A:      # JSON
                gltf = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:    # BIN
                buffers.append(data)
        return gltf, buffers


def _load_buffers(gltf, base_dir, glb_buffers):
    out = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_buffers[i])
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(gltf, buffers, idx):
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype().itemsize * ncomp
    itemsize = dtype().itemsize
    if stride == itemsize * ncomp:
        arr = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=offset)
        return arr.reshape(count, ncomp) if ncomp > 1 else arr
    # strided
    raw = np.frombuffer(buf, dtype=np.uint8,
                        count=stride * (count - 1) + itemsize * ncomp, offset=offset)
    strided = np.lib.stride_tricks.as_strided(
        raw.view(dtype), shape=(count, ncomp), strides=(stride, itemsize))
    return np.ascontiguousarray(strided)


def _image_raster(gltf, buffers, base_dir, img_idx):
    img = gltf["images"][img_idx]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            return tex.decode_image_bytes(base64.b64decode(uri.split(",", 1)[1]))
        return tex.load_texture(os.path.join(base_dir, uri))
    view = gltf["bufferViews"][img["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    off = view.get("byteOffset", 0)
    return tex.decode_image_bytes(buf[off:off + view["byteLength"]])


def _texture_raster(gltf, buffers, base_dir, tex_info):
    if tex_info is None:
        return None
    t = gltf["textures"][tex_info["index"]]
    if "source" not in t:
        return None
    return _image_raster(gltf, buffers, base_dir, t["source"])


def _read_document(path: str):
    base_dir = os.path.dirname(path)
    if path.lower().endswith(".glb"):
        gltf, glb_buffers = _read_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_buffers = []
    return gltf, _load_buffers(gltf, base_dir, glb_buffers), base_dir


def _primitive_fat(gltf, buffers, prim):
    """De-indexed (corners, normals, uvs) for one triangle primitive."""
    attrs = prim["attributes"]
    pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
    if "indices" in prim:
        idx = _accessor(gltf, buffers, prim["indices"]).astype(np.int64).reshape(-1)
    else:
        idx = np.arange(len(pos), dtype=np.int64)
    nrm = (_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
           if "NORMAL" in attrs else None)
    uv = (_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
          if "TEXCOORD_0" in attrs else None)
    c = pos[idx]
    if nrm is not None:
        n = nrm[idx]
    else:
        t = c.reshape(-1, 3, 3)
        fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
        n = np.repeat(fn, 3, axis=0)
    if uv is not None:
        u = uv[idx].copy()
        u[:, 1] = 1.0 - u[:, 1]   # aiProcess_FlipUVs
    else:
        u = np.zeros((len(idx), 2), np.float32)
    return c, n, u


def _face_normals(corner):
    t = corner.reshape(-1, 3, 3)
    fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    return fn.astype(np.float32)


def _material_model(gltf, buffers, base_dir, mat_idx, corner, normal, uv,
                    stem, texture_ext) -> MeshModel:
    """MeshModel from fat arrays + one glTF material (factors + textures,
    with the reference's <name>_<type><ext> naming convention taking
    precedence — LoadTexture, Core/Model.cpp:183-204)."""
    def conv(kind):
        return tex.load_texture(os.path.join(base_dir, f"{stem}_{kind}{texture_ext}"))

    albedo = conv("albedo")
    normal_map = conv("normal")
    rma = conv("metalness")      # reference's "metalness" file IS the RMA map
    emission = conv("emission")

    base_color = (0.8, 0.8, 0.8)
    metalness, roughness = 0.0, 0.5
    emissive = (0.0, 0.0, 0.0)
    mats = gltf.get("materials", [])
    if mat_idx is not None and mat_idx < len(mats):
        m = mats[mat_idx]
        pbr = m.get("pbrMetallicRoughness", {})
        if "baseColorFactor" in pbr:
            base_color = tuple(pbr["baseColorFactor"][:3])
        metalness = pbr.get("metallicFactor", 1.0 if "metallicRoughnessTexture" in pbr else 0.0)
        roughness = pbr.get("roughnessFactor", 0.5)
        emissive = tuple(m.get("emissiveFactor", [0, 0, 0]))
        if albedo is None:
            albedo = _texture_raster(gltf, buffers, base_dir, pbr.get("baseColorTexture"))
        if normal_map is None:
            normal_map = _texture_raster(gltf, buffers, base_dir, m.get("normalTexture"))
        if rma is None:
            # glTF metallicRoughness: G = roughness, B = metalness — the same
            # channel layout the engine expects; use directly.
            rma = _texture_raster(gltf, buffers, base_dir, pbr.get("metallicRoughnessTexture"))
        if emission is None:
            emission = _texture_raster(gltf, buffers, base_dir, m.get("emissiveTexture"))

    return MeshModel(
        corners=corner, normals=normal, uvs=uv, face_normals=_face_normals(corner),
        name=stem, base_color=base_color, metalness=float(metalness),
        roughness=float(roughness), emissive=emissive,
        albedo_texture=albedo, normal_texture=normal_map,
        rma_texture=rma, emission_texture=emission)


def load_gltf_multi(path: str, name: str | None = None,
                    texture_ext: str = ".png") -> list[MeshModel]:
    """Load a .gltf/.glb as ONE MeshModel PER MATERIAL (primitives sharing a
    material merge): multi-material meshes keep every material; callers
    instance all returned models with the same transform."""
    gltf, buffers, base_dir = _read_document(path)
    stem = name or os.path.splitext(os.path.basename(path))[0]

    groups: dict = {}
    order: list = []
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue
            key = prim.get("material")
            if key not in groups:
                groups[key] = ([], [], [])
                order.append(key)
            c, n, u = _primitive_fat(gltf, buffers, prim)
            groups[key][0].append(c)
            groups[key][1].append(n)
            groups[key][2].append(u)

    out = []
    for key in order:
        cs, ns, us = groups[key]
        m = _material_model(
            gltf, buffers, base_dir, key,
            np.concatenate(cs), np.concatenate(ns), np.concatenate(us),
            stem, texture_ext)
        if len(order) > 1:
            m = dataclasses.replace(m, name=f"{stem}.mat{key}")
        out.append(m)
    return out


def load_gltf(path: str, name: str | None = None, texture_ext: str = ".png",
              merge_primitives: bool = True) -> MeshModel:
    """Load a .gltf/.glb file into ONE MeshModel (world units, fat arrays).

    All primitives merge; material factors/textures come from the FIRST
    material (use load_gltf_multi to keep every material)."""
    gltf, buffers, base_dir = _read_document(path)
    stem = name or os.path.splitext(os.path.basename(path))[0]

    corners, normals, uvs = [], [], []
    first_mat = None
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue
            if first_mat is None:
                first_mat = prim.get("material", 0)
            c, n, u = _primitive_fat(gltf, buffers, prim)
            corners.append(c)
            normals.append(n)
            uvs.append(u)
            if not merge_primitives:
                break
        if not merge_primitives and corners:
            break

    corner = np.concatenate(corners) if corners else np.zeros((0, 3), np.float32)
    normal = np.concatenate(normals) if normals else np.zeros((0, 3), np.float32)
    uv = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)
    return _material_model(gltf, buffers, base_dir, first_mat or 0,
                           corner, normal, uv, stem, texture_ext)
