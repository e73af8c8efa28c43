"""Scene assembly; counterpart of ``physically_based_ray_tracer_tpu/scene/scene.py``.

Models + instances -> ``SceneData`` on one device. ``build_scene`` bakes
instance transforms into world space and builds one single-level dense BVH;
``build_scene_instanced`` builds a shared BLAS per model plus a TLAS over
instances, or flattens under the same ``flatten="auto"`` policy as the JAX
package, so both packages trace the same tables. Both also build the
classic 2-wide BVH over the world-baked triangles (``SceneData.bvh``, the
wave engine's tree), unless ``build_scene_instanced`` is given
``legacy_bvh=False``: then ``bvh`` is None, where the JAX package stores a
1-triangle placeholder, and the wave engine refuses the scene.

``build_scene_instanced`` also returns the host-side ``InstancedScene``
handle, and ``rebuild_scene`` moves instances with it (the per-frame
Synchronise -> BuildTLAS step): the TLAS head and instance rows are
rebuilt (``bvh/dense.py::refresh_tlas``), the moved instances' slices of
the shading arrays are re-baked and scattered, and the BLAS and group
tables are kept as they are. Every result tensor is new: nothing of the
scene passed in is written, so it renders as before.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.bvh.builder import build_bvh, bvh_depth
from physically_based_ray_tracer_tpu_torch.bvh.dense import (GROUP_ROWS,
                                                             NODE_F, DenseBVH,
                                                             TLASMeta,
                                                             build_dense,
                                                             build_dense_tlas,
                                                             refresh_tlas)
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.math import (
    compose_trs, inverse_transpose_3x3, transform_points)
from physically_based_ray_tracer_tpu_torch.utils.profiling import add_attrs, annotate


@dataclass
class MeshModel:
    """Host-side model: fat corner arrays + material + optional textures."""

    corners: np.ndarray                      # (3T, 3) f32
    normals: np.ndarray                      # (3T, 3) f32
    uvs: np.ndarray                          # (3T, 2) f32
    face_normals: np.ndarray                 # (T, 3) f32
    name: str = "model"
    base_color: tuple = (0.8, 0.8, 0.8)
    metalness: float = 0.0
    roughness: float = 0.5
    emissive: tuple = (0.0, 0.0, 0.0)
    transmissivness: float = 0.0
    reflectance: float = 0.5
    opacity: float = 1.0
    albedo_texture: Optional[np.ndarray] = None    # (H, W) uint32 ARGB
    normal_texture: Optional[np.ndarray] = None
    rma_texture: Optional[np.ndarray] = None
    emission_texture: Optional[np.ndarray] = None

    @property
    def n_tris(self) -> int:
        return self.corners.shape[0] // 3

    @staticmethod
    def from_fat(fat, **kw) -> "MeshModel":
        corners, normals, uvs, face_normals = fat
        return MeshModel(corners=corners, normals=normals, uvs=uvs,
                         face_normals=face_normals, **kw)


@dataclass
class Instance:
    """Model index + TRS."""

    model: int
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)   # Euler radians
    scale: tuple = (1.0, 1.0, 1.0)
    name: str = "object"

    @property
    def transform(self) -> np.ndarray:
        return compose_trs(self.position, self.rotation, self.scale)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Everything the integrator needs, as tensors on one device."""

    dense: DenseBVH
    tri_v0: torch.Tensor        # (P, 3) world, original prim order
    tri_e1: torch.Tensor        # (P, 3)
    tri_e2: torch.Tensor        # (P, 3)
    face_normal: torch.Tensor   # (P, 3) world, normalized
    corner_normal: torch.Tensor  # (3P, 3) world
    corner_uv: torch.Tensor     # (3P, 2)
    prim_model: torch.Tensor    # (P,) i32
    prim_inst: torch.Tensor     # (P,) i32
    mat_base: torch.Tensor         # (M, 3)
    mat_metal: torch.Tensor        # (M,)
    mat_rough: torch.Tensor        # (M,)
    mat_emissive: torch.Tensor     # (M, 3)
    mat_transmissive: torch.Tensor  # (M,)
    mat_reflectance: torch.Tensor  # (M,)
    mat_opacity: torch.Tensor      # (M,)
    tex_record: torch.Tensor       # (M, 4, 3) i32: offset(-1=none), width, height
    texel_pool: torch.Tensor       # (K,) texels as i64 (uint32 values)
    lights: LightSet
    sky: torch.Tensor              # (Hs, Ws, 3) f32; (1,1,3) zeros if absent
    bvh: Optional[BVHArrays] = None  # classic BVH (wave engine); None if not built

    @property
    def n_prims(self) -> int:
        return self.tri_v0.shape[0]

    def to(self, device) -> "SceneData":
        kw = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            kw[f.name] = None if x is None else x.to(device)
        return SceneData(**kw)


def _bake_world(models, instances):
    """World-space shading arrays in per-instance-concatenated prim order."""
    all_corners, all_normals, all_uvs, all_face_n = [], [], [], []
    prim_model, prim_inst = [], []
    for inst_id, inst in enumerate(instances):
        mdl = models[inst.model]
        m = inst.transform
        nrm_m = inverse_transpose_3x3(m)
        wc = transform_points(m, mdl.corners)
        wn = mdl.normals @ nrm_m.T
        wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-20)
        wf = mdl.face_normals @ nrm_m.T
        wf /= np.maximum(np.linalg.norm(wf, axis=1, keepdims=True), 1e-20)
        all_corners.append(wc.astype(np.float32))
        all_normals.append(wn.astype(np.float32))
        all_uvs.append(mdl.uvs.astype(np.float32))
        all_face_n.append(wf.astype(np.float32))
        prim_model.append(np.full(mdl.n_tris, inst.model, np.int32))
        prim_inst.append(np.full(mdl.n_tris, inst_id, np.int32))
    corners = np.concatenate(all_corners)
    return dict(
        tri=corners.reshape(-1, 3, 3),
        face_n=np.concatenate(all_face_n),
        normals=np.concatenate(all_normals),
        uvs=np.concatenate(all_uvs),
        prim_model=np.concatenate(prim_model),
        prim_inst=np.concatenate(prim_inst),
    )


def _texture_pool(models):
    pool_parts: list[np.ndarray] = []
    tex_record = np.full((len(models), 4, 3), -1, np.int32)
    offset = 0
    for mi, mdl in enumerate(models):
        for ki, raster in enumerate([mdl.albedo_texture, mdl.normal_texture,
                                     mdl.rma_texture, mdl.emission_texture]):
            if raster is None:
                continue
            r = np.ascontiguousarray(raster, np.uint32)
            h, w = r.shape
            tex_record[mi, ki] = (offset, w, h)
            pool_parts.append(r.reshape(-1))
            offset += w * h
    texel_pool = (np.concatenate(pool_parts) if pool_parts
                  else np.zeros((1,), np.uint32))
    return tex_record, texel_pool


def _assemble(models, dense, baked, lights, sky, device, bvh=None):
    tri = baked["tri"]
    v0 = tri[:, 0]
    tex_record, texel_pool = _texture_pool(models)
    if sky is None:
        sky = np.zeros((1, 1, 3), np.float32)
    lights = lights if lights is not None else LightSet.make(device=device)
    arrays = dict(
        tri_v0=v0, tri_e1=tri[:, 1] - v0, tri_e2=tri[:, 2] - v0,
        face_normal=baked["face_n"], corner_normal=baked["normals"],
        corner_uv=baked["uvs"], prim_model=baked["prim_model"],
        prim_inst=baked["prim_inst"],
        mat_base=[m.base_color for m in models],
        mat_metal=[m.metalness for m in models],
        mat_rough=[m.roughness for m in models],
        mat_emissive=[m.emissive for m in models],
        mat_transmissive=[m.transmissivness for m in models],
        mat_reflectance=[m.reflectance for m in models],
        mat_opacity=[m.opacity for m in models],
        tex_record=tex_record, texel_pool=texel_pool, sky=sky)
    return _from_arrays(arrays, dense.to(device), lights.to(device), device,
                        None if bvh is None else bvh.to(device))


_INT_FIELDS = {"prim_model": np.int32, "prim_inst": np.int32,
               "tex_record": np.int32, "texel_pool": np.int64}


def _from_arrays(arrays: dict, dense: DenseBVH, lights: LightSet,
                 device, bvh: BVHArrays | None = None) -> SceneData:
    kw = {}
    for name, x in arrays.items():
        dtype = _INT_FIELDS.get(name, np.float32)
        kw[name] = torch.from_numpy(np.array(x, dtype=dtype)).to(device)
    return SceneData(dense=dense, lights=lights, bvh=bvh, **kw)


def scene_from_numpy(arrays: dict, device=DEFAULT_DEVICE) -> SceneData:
    """The port's SceneData from the JAX package's SceneData fields.

    ``arrays`` maps each SceneData field name to ``np.asarray`` of the JAX
    field, except ``dense``, ``lights`` and ``bvh``, which map to dicts of
    their own fields (DenseBVH: nodes16, groups, inst16, prim_base,
    world_lo, world_hi, and groups_bf, glo, pids_c where present; LightSet:
    its twelve arrays; BVHArrays: nodes_box, nodes_child, tris, prim_index,
    tris_woop). ``groups_bf`` keeps its bf16 bits (``DenseBVH.from_numpy``).
    Without a ``bvh`` entry the scene has no classic BVH. Tests use this so
    that both packages trace identical tables."""
    device = resolve(device)
    d = arrays["dense"]
    dense = DenseBVH.from_numpy(d["nodes16"], d["groups"], d["inst16"],
                                d["prim_base"], d["world_lo"], d["world_hi"],
                                groups_bf=d.get("groups_bf"), glo=d.get("glo"),
                                pids_c=d.get("pids_c"), device=device)
    lights = LightSet(**{k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                         for k, v in arrays["lights"].items()})
    bvh = arrays.get("bvh")
    if bvh is not None:
        bvh = BVHArrays.from_numpy(**bvh, device=device)
    rest = {k: v for k, v in arrays.items()
            if k in {f.name for f in dataclasses.fields(SceneData)}
            and k not in ("dense", "lights", "bvh")}
    return _from_arrays(rest, dense, lights, device, bvh)


def build_scene(models: list[MeshModel], instances: list[Instance],
                lights: LightSet | None = None, sky: np.ndarray | None = None,
                leaf_size: int = 16, dense_leaf_target: int = 16,
                dense_shape: bool = True,
                device=DEFAULT_DEVICE) -> tuple[SceneData, int]:
    """Bake instances to world space, build the classic BVH and the
    single-level dense BVH. Returns (scene_data, depth of the classic BVH),
    as the JAX package does."""
    device = resolve(device)
    baked = _bake_world(models, instances)
    bvh = build_bvh(baked["tri"], leaf_size=leaf_size)
    dense, _ = build_dense(baked["tri"], leaf_target=dense_leaf_target,
                           shape=dense_shape)
    return _assemble(models, dense, baked, lights, sky, device, bvh), bvh_depth(bvh)


# Scene-adaptive layout policy, kept identical to the JAX package so both
# build the same tables. The thresholds are TPU-derived: SMEM_NODE_LIMIT
# (192 KB of scalar memory for the node table) and VMEM_GROUP_LIMIT (10.5 MB
# of vector memory for the leaf groups) bound what the TPU kernel keeps in
# fast memory. A GPU has no such tiers: the bench table fits its 50 MB L2,
# the SPD sphereflake's (benchmark configuration spd_balls_sf4_512, 7,382
# meshes, ~340 MB read by B1) does not; fitting the policy to the GPU kernel
# is later perf work.
FLATTEN_MAX_INSTANCES = 128
FLATTEN_MAX_TRIS = 1 << 18
SMEM_NODE_LIMIT = 3072
VMEM_GROUP_LIMIT = 1280


def _dense_fits_fast_memory(dense: DenseBVH) -> bool:
    n_nodes = dense.nodes16.shape[0] // NODE_F
    n_groups = dense.groups.shape[0] // GROUP_ROWS
    return n_nodes <= SMEM_NODE_LIMIT and n_groups <= VMEM_GROUP_LIMIT


@dataclass
class InstancedScene:
    """Host-side handle of a scene built by ``build_scene_instanced``: what
    ``rebuild_scene`` needs to track instance motion without rebuilding the
    BLAS or group tables. ``prim_start`` / ``prim_count``: each instance's
    slice of the scene's prim order."""

    models: list[MeshModel]
    instances: list[Instance]
    tlas_meta: TLASMeta | None      # None = flattened (world-baked) layout
    leaf_size: int
    legacy_bvh: bool
    prim_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    prim_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dense_leaf_target: int = 16
    dense_shape: bool = True
    # per device: each model's corners, normals and face normals, and each
    # instance's prim rows, as tensors there (``rebuild_scene`` bakes on it)
    on_device: dict = field(default_factory=dict, repr=False, compare=False)

    def tensors(self, dev: torch.device) -> tuple[list, list]:
        """(per model (corners, normals, face normals), per instance its
        rows of the prim order), on ``dev``, made on first use."""
        if dev not in self.on_device:
            t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            models = [(t(m.corners), t(m.normals), t(m.face_normals)) for m in self.models]
            rows = [torch.arange(s, s + c, device=dev)
                    for s, c in zip(self.prim_start.tolist(), self.prim_count.tolist())]
            self.on_device[dev] = (models, rows)
        return self.on_device[dev]


def _instance_offsets(models, instances):
    counts = np.array([models[i.model].n_tris for i in instances], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return starts, counts


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (..., 3) over their length floored at 1e-20: the
    squares summed x + y + z in order, as numpy's norm over a row of three
    sums them, and the root taken in f64, so that it is the correctly
    rounded f32 root on any device (a CPU's vector f32 root is not)."""
    sq = x * x
    length = torch.sqrt((sq[..., 0] + sq[..., 1] + sq[..., 2]).double()).float()
    return x / torch.clamp_min(length, 1e-20)[..., None]


def _bake_moved(handle: InstancedScene, instances: list[Instance], moved: list[int],
                dev: torch.device):
    """The moved instances' world-space shading arrays, baked on ``dev``:
    (prim rows, corner-normal rows, [v0, e1, e2, face normals, corner
    normals]), the values in the rows' order. One upload of the instances'
    matrices, then batched per model: ``corners @ M.T + t`` and the normals
    through the inverse transpose of M, in f32 as ``_bake_world`` computes
    them on the host (on the CPU, byte for byte)."""
    models, rows = handle.tensors(dev)
    mats = np.stack([np.concatenate([instances[i].transform[:3, :3].T.ravel(),
                                     instances[i].transform[:3, 3],
                                     inverse_transpose_3x3(instances[i].transform).T.ravel()])
                     for i in moved]).astype(np.float32)
    mats = torch.from_numpy(mats).to(dev)
    by_model: dict[int, list[int]] = {}
    for j, i in enumerate(moved):
        by_model.setdefault(instances[i].model, []).append(j)
    order, parts = [], []
    for model, js in by_model.items():
        corners, normals, face_normals = models[model]
        m = mats[js]
        rot, shift, nrm = m[:, :9].view(-1, 3, 3), m[:, 9:12][:, None], m[:, 12:].view(-1, 3, 3)
        tri = (torch.matmul(corners, rot) + shift).view(len(js), -1, 3, 3)
        v0 = tri[:, :, 0]
        parts.append((v0, tri[:, :, 1] - v0, tri[:, :, 2] - v0,
                      _unit_rows(torch.matmul(face_normals, nrm)),
                      _unit_rows(torch.matmul(normals, nrm))))
        order += [moved[j] for j in js]
    idx = torch.cat([rows[i] for i in order])
    cidx = (3 * idx[:, None] + torch.arange(3, device=dev)).view(-1)
    return idx, cidx, [torch.cat([p[k].reshape(-1, 3) for p in parts]) for k in range(5)]


def build_scene_instanced(models: list[MeshModel], instances: list[Instance],
                          lights: LightSet | None = None,
                          sky: np.ndarray | None = None,
                          leaf_size: int = 16, dense_leaf_target: int = 16,
                          dense_shape: bool = True,
                          legacy_bvh: bool = True,
                          flatten: bool | str = False,
                          blas_workers: int | str = "auto",
                          device=DEFAULT_DEVICE,
                          ) -> tuple[SceneData, InstancedScene, int]:
    """Two-level build: shared BLAS per model + TLAS over instances.

    ``legacy_bvh``: also build the classic BVH over the world-baked
    triangles (``leaf_size`` per leaf; the wave engine's tree); False leaves
    ``SceneData.bvh`` None.

    ``flatten``: False keeps the two-level structure (the layout for scenes
    that move: ``rebuild_scene`` then refreshes the TLAS only); "auto"
    world-bakes small scenes into one single-level tree when the flattened
    tables pass the fast-memory check; True forces flattening
    (``rebuild_scene`` then rebuilds the dense table on motion).

    ``blas_workers``: the processes that build the two-level table's
    BLASes (``build_dense_tlas``'s ``workers``): "auto" spawns one a core
    for large tables only, 0 builds them in this process.

    The dense tables are built in a ``pbrt.build`` span (attributes
    ``blas``: the BLASes, 0 when flattened; ``tris``: the triangles in the
    tables; ``groups``: their leaf groups; ``workers``: the processes that
    built the BLASes, 0 when built here).

    Returns (scene_data, instanced_handle, depth): the larger of the dense
    and the classic tree's depth, as in the JAX package."""
    device = resolve(device)
    baked = _bake_world(models, instances)
    do_flatten = (flatten is True) or (
        flatten == "auto" and len(instances) <= FLATTEN_MAX_INSTANCES
        and baked["tri"].shape[0] <= FLATTEN_MAX_TRIS)
    meta = None
    with annotate("pbrt.build", workers=0):
        if do_flatten:
            dense, depth = build_dense(baked["tri"], leaf_target=dense_leaf_target,
                                       shape=dense_shape)
            if flatten == "auto" and not _dense_fits_fast_memory(dense):
                do_flatten = False
        if not do_flatten:
            mesh_tris = [m.corners.reshape(-1, 3, 3).astype(np.float32)
                         for m in models]
            inst_mesh = np.array([i.model for i in instances], np.int64)
            transforms = np.stack([i.transform
                                   for i in instances]).astype(np.float32)
            dense, meta, depth = build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                                  leaf_target=dense_leaf_target,
                                                  shape=dense_shape, workers=blas_workers)
        add_attrs(blas=0 if meta is None else len(models),
                  tris=baked["tri"].shape[0] if meta is None else sum(m.n_tris for m in models),
                  groups=dense.n_groups)
    bvh = None
    if legacy_bvh:
        bvh = build_bvh(baked["tri"], leaf_size=leaf_size)
        depth = max(bvh_depth(bvh), depth)
    data = _assemble(models, dense, baked, lights, sky, device, bvh)
    starts, counts = _instance_offsets(models, instances)
    handle = InstancedScene(models=models, instances=list(instances),
                            tlas_meta=meta, leaf_size=leaf_size,
                            legacy_bvh=legacy_bvh, prim_start=starts,
                            prim_count=counts,
                            dense_leaf_target=dense_leaf_target,
                            dense_shape=dense_shape)
    return data, handle, depth


def rebuild_scene(data: SceneData, handle: InstancedScene,
                  instances: list[Instance], device=DEFAULT_DEVICE) -> SceneData:
    """The scene after instance transform changes (mesh membership
    unchanged: the same model in every instance slot), on ``device`` (where
    ``data`` already lies, as a Renderer's scene does, nothing moves).

    Instances whose transform changed (``np.allclose``) are re-baked on
    the scene's device (``_bake_moved``: one upload of their matrices, no
    host array work per triangle), and their prim slices of
    ``tri_v0/e1/e2``, ``face_normal`` and the interleaved
    ``corner_normal`` are scattered into copies, one batched scatter per
    array. A two-level table gets ``refresh_tlas`` (the BLAS
    and group tensors are shared with ``data``); a flattened one
    (``handle.tlas_meta is None``) is rebuilt by ``build_dense`` when
    something moved; with ``handle.legacy_bvh`` the classic BVH is rebuilt
    by the native builder. ``handle.instances`` becomes ``instances``.
    Nothing of ``data`` is written. While the program's spans record, the
    innermost open span gets ``moved`` and ``tris``: the instances and the
    triangles re-baked."""
    if len(instances) != len(handle.instances):
        raise AssertionError("rebuild_scene: the instance count changed")
    if any(a.model != b.model for a, b in zip(instances, handle.instances)):
        raise AssertionError("rebuild_scene: an instance slot changed its model")
    data = data.to(resolve(device))
    dev = data.tri_v0.device

    moved = [i for i, (a, b) in enumerate(zip(instances, handle.instances))
             if not np.allclose(a.transform, b.transform)]
    handle.instances = list(instances)
    add_attrs(moved=len(moved), tris=int(handle.prim_count[moved].sum()))
    arrays = {k: getattr(data, k) for k in ("tri_v0", "tri_e1", "tri_e2",
                                            "face_normal", "corner_normal")}
    if moved:
        # corner normals are interleaved per prim (3P, 3): corner c of prim
        # p at row 3p + c, as the baked corner normals run
        idx, cidx, new = _bake_moved(handle, instances, moved, dev)
        for (k, x), rows, vals in zip(arrays.items(), [idx] * 4 + [cidx], new):
            arrays[k] = x.index_put((rows,), vals)
    tris = [arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2")]
    if handle.tlas_meta is not None:
        transforms = np.stack([i.transform for i in instances]).astype(np.float32)
        dense = refresh_tlas(data.dense, handle.tlas_meta, transforms)
    elif moved:
        dense, _ = build_dense(world_tris(*tris), leaf_target=handle.dense_leaf_target,
                               shape=handle.dense_shape)
        dense = dense.to(dev)
    else:
        dense = data.dense
    bvh = data.bvh
    if handle.legacy_bvh:
        bvh = build_bvh(world_tris(*tris), leaf_size=handle.leaf_size).to(dev)
    return dataclasses.replace(data, bvh=bvh, dense=dense, **arrays)


def world_tris(tri_v0, tri_e1, tri_e2) -> np.ndarray:
    """(P, 3, 3) world triangles from a scene's v0, e1, e2 tensors, on the
    host, summed in f32 as the JAX package sums them."""
    v0, e1, e2 = (x.cpu().numpy() for x in (tri_v0, tri_e1, tri_e2))
    return np.stack([v0, v0 + e1, v0 + e2], axis=1)
