"""Instance-partitioned tracing for scenes beyond one device's memory;
counterpart of ``physically_based_ray_tracer_tpu/parallel/object_partition.py``.

The memory that outgrows a device is the acceleration structure and its
leaf geometry, so the tables are sharded and the rays replicated:

  * instances are dealt round-robin over the mesh's ranks; each rank holds
    a dense TLAS + BLAS over ITS instances only (``PartitionedScene.local``:
    one shard's ``DenseBVH`` on the rank's device);
  * every rank traces all rays against its sub-scene (the port's
    ``sorted_closest_dense`` / ``intersect_closest_dense`` and the ``_any``
    pair: kernel B1 on the card, its plain version on the CPU);
  * one round of collectives combines the per-ray results: closest = the
    smallest t, an exact t-tie going to the lowest rank (pmin, then a
    masked psum); occlusion = any (pmax).

Per-lane results are functions of (ray, sub-scene), so the combined record
equals a trace of the union scene wherever the winner is unique. As in the
JAX package's v1 the bf16 tables are dropped (each shard's compact decode
layout differs) and the f32 engine traces.

``partition_instances`` and ``PartitionedScene`` are host numpy, line for
line the JAX package's: every field is stacked over shards, zero-padded to
the largest (padded nodes and groups are unreachable from each root).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import DenseBVH, build_dense_tlas
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops import trace
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit
from physically_based_ray_tracer_tpu_torch.parallel.mesh import Mesh

# the DenseBVH tables a shard carries (the bf16 ones are dropped)
TABLES = ("nodes16", "groups", "inst16", "prim_base", "world_lo", "world_hi")


@dataclasses.dataclass
class PartitionedScene:
    """Shard-stacked dense scene (host numpy): every table in ``dbvh`` has
    a leading (n_shards,) axis."""

    dbvh: dict                # table name -> (S, ...) array
    inst_gmap: np.ndarray     # (S, Imax) i32: local inst -> global inst
    prim_off: np.ndarray      # (S, Imax) i32: + local->global prim delta
    n_shards: int
    max_depth: int
    _local: dict = dataclasses.field(default_factory=dict, repr=False)

    def local(self, shard: int, device) -> tuple[DenseBVH, torch.Tensor, torch.Tensor]:
        """Shard ``shard``'s tables as a ``DenseBVH`` on ``device``, with its
        instance map and prim offsets (built once per shard and device)."""
        key = (shard, str(device))
        if key not in self._local:
            t = {f: self.dbvh[f][shard] for f in TABLES}
            db = DenseBVH.from_numpy(t["nodes16"], t["groups"], t["inst16"],
                                     t["prim_base"], t["world_lo"], t["world_hi"],
                                     device=device)
            self._local[key] = (db, torch.from_numpy(self.inst_gmap[shard]).to(device),
                                torch.from_numpy(self.prim_off[shard]).to(device))
        return self._local[key]


def _pad_to(a: np.ndarray, rows: int, fill=0.0) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


def partition_instances(mesh_tris, inst_mesh, transforms, n_shards: int,
                        leaf_target: int = 16) -> PartitionedScene:
    """Round-robin the instances over ``n_shards`` sub-scenes.

    Shards beyond the instance count get one scale-zero dummy instance
    (degenerate triangles: every leaf test rejects on |det|, so they can
    never produce a hit)."""
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    I = len(inst_mesh)

    # global per-instance prim offsets (the SceneData convention:
    # instances concatenated in global order)
    counts = np.array([len(mesh_tris[m]) for m in inst_mesh], np.int64)
    g_base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)

    shard_dbs, shard_gmap, shard_poff, depths = [], [], [], []
    for s in range(n_shards):
        sel = np.arange(I)[s::n_shards]
        if len(sel) == 0:
            # dummy shard: one epsilon-scale instance of the smallest mesh,
            # degenerate at f32 (areas ~1e-24, under every |det| cutoff)
            # while the transform stays invertible for the builder
            m_small = int(np.argmin([len(t) for t in mesh_tris]))
            tiny = np.diag([1e-12, 1e-12, 1e-12, 1.0]).astype(np.float32)
            db, _meta, dep = build_dense_tlas(
                [mesh_tris[m_small]], np.array([0], np.int64),
                tiny[None], leaf_target=leaf_target, shape=True)
            gmap = np.zeros(1, np.int32)
            poff = np.zeros(1, np.int32)
        else:
            # ship ONLY the meshes this shard's instances use: the BLAS
            # leaf groups are where the memory is
            used = np.unique(inst_mesh[sel])
            remap = np.full(len(mesh_tris), -1, np.int64)
            remap[used] = np.arange(len(used))
            db, _meta, dep = build_dense_tlas(
                [mesh_tris[m] for m in used], remap[inst_mesh[sel]],
                transforms[sel], leaf_target=leaf_target, shape=True)
            l_base = db.prim_base.numpy().astype(np.int64)
            gmap = sel.astype(np.int32)
            poff = (g_base[sel] - l_base[: len(sel)]).astype(np.int32)
        shard_dbs.append({f: getattr(db, f).numpy() for f in TABLES})
        shard_gmap.append(gmap)
        shard_poff.append(poff)
        depths.append(dep)

    rows = {f: max(db[f].shape[0] for db in shard_dbs)
            for f in ("nodes16", "groups", "inst16", "prim_base")}
    imax = max(g.shape[0] for g in shard_gmap)
    dbvh = {f: np.stack([_pad_to(db[f], rows.get(f, db[f].shape[0])) for db in shard_dbs])
            for f in TABLES}
    gmap = np.stack([_pad_to(g, imax) for g in shard_gmap])
    poff = np.stack([_pad_to(p, imax) for p in shard_poff])
    return PartitionedScene(dbvh=dbvh, inst_gmap=gmap, prim_off=poff,
                            n_shards=n_shards, max_depth=max(depths))


def _local_to_global(gmap: torch.Tensor, poff: torch.Tensor, hit: Hit) -> Hit:
    li = torch.clamp(hit.inst, 0, gmap.shape[0] - 1).long()
    found = hit.prim >= 0
    neg = torch.full_like(hit.prim, -1)
    return hit._replace(prim=torch.where(found, hit.prim + poff[li], neg),
                        inst=torch.where(found, gmap[li], neg))


def _combine_closest(hit: Hit, mesh: Mesh) -> Hit:
    """Smallest t across the ranks; an exact t-tie goes to the lowest rank."""
    found = hit.prim >= 0
    far = torch.full_like(hit.t, BVH_FAR)
    t = torch.where(found, hit.t, far)
    tmin = mesh.pmin(t)
    found_any = tmin < BVH_FAR * 0.5
    win = found & (t <= tmin)
    rank = torch.where(win, mesh.rank, mesh.size).to(torch.int32)
    keep = win & (mesh.pmin(rank) == mesh.rank)

    def sel(x):
        return mesh.psum(torch.where(keep, x, torch.zeros_like(x)))

    neg = torch.full_like(hit.prim, -1)
    return Hit(t=torch.where(found_any, tmin, far), u=sel(hit.u), v=sel(hit.v),
               prim=torch.where(found_any, sel(hit.prim), neg),
               inst=torch.where(found_any, sel(hit.inst), neg))


def _check(ps: PartitionedScene, mesh: Mesh) -> None:
    if mesh.size != ps.n_shards:
        raise ValueError(f"a scene of {ps.n_shards} shards on a mesh of {mesh.size} ranks")


def partitioned_closest(ps: PartitionedScene, mesh: Mesh, o, d, t_max=None,
                        sort: bool = True) -> Hit:
    """Closest hit of replicated rays against the partitioned scene, with
    GLOBAL prim / instance ids, the same on every rank. Rank r traces shard
    r's tables."""
    _check(ps, mesh)
    db, gmap, poff = ps.local(mesh.rank, mesh.device)
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    fn = trace.sorted_closest_dense if sort else trace.intersect_closest_dense
    hit = _local_to_global(gmap, poff, fn(db, o, d, t_max))
    return _combine_closest(hit, mesh)


def partitioned_any(ps: PartitionedScene, mesh: Mesh, o, d, t_max,
                    sort: bool = True) -> torch.Tensor:
    """Occlusion of replicated rays: any shard's occluder blocks."""
    _check(ps, mesh)
    db, _, _ = ps.local(mesh.rank, mesh.device)
    fn = trace.sorted_any_dense if sort else trace.intersect_any_dense
    return mesh.pmax(fn(db, o, d, t_max).to(torch.int32)) > 0


def table_bytes(db: DenseBVH) -> int:
    """Bytes of the tables a rank holds for B1: the f32 ``TABLES`` and the
    derived ``leaf_rec``."""
    return sum(getattr(db, f).numel() * getattr(db, f).element_size()
               for f in TABLES + ("leaf_rec",))
