"""Dense-leaf BVH (+ two-level TLAS); counterpart of ``physically_based_ray_tracer_tpu/bvh/dense.py``.

The host-side build is numpy and is carried over line for line, so the port
builds tables byte-identical to the JAX package's (a test pins that). Only
the container differs: ``DenseBVH`` holds torch tensors and moves with
``.to(device)``.

Layouts (shared with the traversal kernels, ``csrc/traverse_f32.cu`` and
``csrc/traverse_bf16.cu``):
  * ``nodes16`` (N*16,) f32, per node:
      [c0min(3), c0max(3), c1min(3), c1max(3), child0, child1, pad, pad]
    children stored as floats (exact for |code| < 2^24):
      code >= 0            -> internal node index
      code <  0, v=-(code+1):
        v & 1 == 0         -> triangle leaf, v >> 1 = group*8 + log2(period)
        v & 1 == 1         -> instance leaf, v >> 1 = instance id
                              (RESTORE_ID is the kernel's restore sentinel)
      code == ABSENT       -> no child in this slot (rejected by code: the
                              min/max slab test is symmetric in lo/hi).
  * ``groups`` (G*16, 128) f32: group g occupies rows [16g, 16g+16); rows
    0..8 are v0.xyz, e1.xyz, e2.xyz, row 9 the primitive id as float (-1 for
    padding). A leaf of k triangles is padded to c = 2^ceil(log2 k) slots and
    the c-block is tiled across the 128 lanes; a GPU thread reads slots
    0..c-1 only.
  * ``inst16`` (I*16,) f32: [0:12] rows of the object-from-world 3x4
    transform, [12] BLAS root node index. A single-level table carries a
    1-float stub instead.
  * ``prim_base`` (max(I,1),) i32: per-instance offset from mesh-local to
    scene-global primitive ids.
  * ``groups_bf`` (G*32, 128) bf16, the bf16 engine's leaf table: row 2*i + b
    of group g is component i (v0 - glo, e1, e2: leaf-local) pre-rolled
    right by (b*c)//2 lanes (band b of 2). ``glo`` (G*8,) f32: per group
    [lo.xyz, 0, hi.xyz, 0], the AABB of its live triangles. ``pids_c``
    (G*C,) f32: the c distinct prim ids of group g at [g*C, g*C + c), padded
    with -1 (C = the largest period). f32 -> bf16 rounds to nearest even,
    as ``ml_dtypes`` does for the JAX package.

Two derived tables, the port's own, are built from those once per
``DenseBVH`` on its device (``__post_init__``), for the kernels' loads:
  * ``leaf_rec`` (G*C, 12) f32, kernel B1's per-triangle leaf records: record
    g*C + j is slot j of group g as three float4, [v0.xyz, prim],
    [e1.xyz, 0], [e2.xyz, 0], for j < c (the group's period, as
    ``_pack_groups_bf`` finds it: the c of the group's node code); records
    c..C-1 are zero with prim -1 (C = the largest period). Built from
    ``groups``, so f32-only tables have it too.
  * ``groups_bf2`` (G, 128, 32) bf16, kernel B2's band pairs: ``groups_bf``
    with each column's 32 rows contiguous, a permutation of its bytes, so
    that rows 2i and 2i+1 (the two bands of component i) form one 32-bit
    bf16x2 word of the column's 64-byte record.

``refresh_tlas`` rewrites the TLAS head of a two-level table after instance
motion and returns a new ``DenseBVH`` that shares every BLAS-side tensor
(``groups``, the bf16 tables and both derived tables) with the old one; the
old table's tensors are never written.

``build_dense_tlas`` builds its BLASes in worker processes once a table is
large (``_blas_workers``): one BLAS does not depend on another, each worker
returns its meshes' nodes and leaf tables in their first C lanes
(``_build_blas``), and the merge is the serial build's, so the tables come
out byte for byte the same.

``hq=True`` builds the tree with the native SBVH builder
(``bvh/native.py``, ``bvh/csrc/sbvh_builder.cpp``): spatial splits, so one
triangle may sit in several leaf groups (each copy with its own prim id
row, the same id). Where that builder cannot run the port raises; the JAX
package falls back silently to the binned core.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.profiling import add_attrs

BINS = 8
LEAF_W = 128          # triangle slots per leaf group (the TPU lane count)
GROUP_ROWS = 16       # rows per group in the flat groups array
GROUP_USED = 10       # of which used: v0, e1, e2, prim; the rest are zero
NODE_F = 16           # floats per node in nodes16
INST_F = 16           # floats per instance in inst16
RESTORE_ID = (1 << 22) - 1   # reserved instance id: ray-space restore pop
ABSENT = -(1 << 30)          # child code of an absent slot (exact in f32)
# the float codes are exact below 2^24: a triangle leaf's -(2*(8g + log2c) + 1)
# for group indices below 2^20, an internal child's node index below 2^24
MAX_GROUPS = 1 << 20
MAX_NODES = 1 << 24
# a two-level build of at least this many meshes and triangles builds its
# BLASes in worker processes; below, a pool's start-up costs more than it saves
PARALLEL_MIN_MESHES = 64
PARALLEL_MIN_TRIS = 1 << 17
TASKS_PER_WORKER = 8


def _check_codes(n_nodes: int, n_groups: int) -> None:
    """Refuses a table whose node codes would not be exact in float32."""
    if n_groups > MAX_GROUPS:
        raise ValueError(f"dense BVH of {n_groups} leaf groups: a triangle leaf's float32 "
                         f"code is exact for at most {MAX_GROUPS} groups")
    if n_nodes > MAX_NODES:
        raise ValueError(f"dense BVH of {n_nodes} nodes: a child's float32 code is exact "
                         f"for at most {MAX_NODES} nodes")


def _tri_code(g: int, log2c: int) -> float:
    return float(-(2 * (g * 8 + log2c) + 1))


def _inst_code(iid: int) -> float:
    return float(-(2 * iid + 2))


def stack_need(nodes16: np.ndarray, inst16: np.ndarray) -> int:
    """Largest traversal-stack occupancy any ray can reach on this table.

    A ray pushes at most one entry (the far child) per internal node on its
    current root-to-node path, plus one restore sentinel per instance entry,
    so the bound is the deepest such path (counted exactly by walking the
    tree; an instance leaf goes on with its BLAS's own need)."""
    nodes = np.asarray(nodes16, np.float32).reshape(-1, NODE_F)
    inst = np.asarray(inst16, np.float32)
    if inst.shape[0] < INST_F:
        return _walk_need(nodes, 0)
    roots = np.rint(inst.reshape(-1, INST_F)[:, 12]).astype(np.int64)
    need_of = {r: _walk_need(nodes, int(r)) for r in np.unique(roots)}
    return _walk_need(nodes, 0, np.array([need_of[r] for r in roots], np.int64))


def _walk_need(nodes: np.ndarray, start: int, inst_need=None) -> int:
    """Deepest path from node ``start`` (counted as 1). Where ``inst_need``
    gives each instance's BLAS need, an instance leaf adds its restore
    sentinel and that need to the path."""
    need = 0
    stack = [(start, 1)]      # (node, entries pushed on the path incl. node)
    while stack:
        n, d = stack.pop()
        need = max(need, d)
        for side in range(2):
            code = int(np.rint(nodes[n, 12 + side]))
            if code == ABSENT:
                continue
            if code >= 0:
                stack.append((code, d + 1))
            elif inst_need is not None and (-(code + 1)) % 2 == 1:
                need = max(need, d + 1 + int(inst_need[(-(code + 1)) // 2]))
    return need


@dataclasses.dataclass(frozen=True)
class DenseBVH:
    """Device-resident dense-leaf BVH (see module docstring for layouts)."""

    nodes16: torch.Tensor    # (N*16,) f32
    groups: torch.Tensor     # (G*16, 128) f32
    inst16: torch.Tensor     # (I*16,) f32, or a (1,) stub when single-level
    prim_base: torch.Tensor  # (max(I,1),) i32
    world_lo: torch.Tensor   # (3,) f32 root bounds (Morton ray sorting)
    world_hi: torch.Tensor   # (3,) f32
    stack_need: int          # stack_need() of these tables
    groups_bf: torch.Tensor | None = None   # (G*32, 128) bf16
    glo: torch.Tensor | None = None         # (G*8,) f32
    pids_c: torch.Tensor | None = None      # (G*C,) f32
    # derived tables (module docstring), built by __post_init__ where absent
    leaf_rec: torch.Tensor | None = None    # (G*C, 12) f32
    groups_bf2: torch.Tensor | None = None  # (G, 128, 32) bf16

    def __post_init__(self):
        if self.leaf_rec is None:
            object.__setattr__(self, "leaf_rec", _leaf_records(self.groups))
        if self.groups_bf2 is None and self.groups_bf is not None:
            object.__setattr__(self, "groups_bf2", _band_pairs(self.groups_bf))

    @staticmethod
    def from_numpy(nodes16, groups, inst16, prim_base, world_lo, world_hi,
                   groups_bf=None, glo=None, pids_c=None,
                   device=DEFAULT_DEVICE) -> "DenseBVH":
        """Tables from numpy arrays. ``groups_bf`` is a torch bf16 tensor or
        any 2-byte numpy array of bf16 bits (e.g. the JAX package's
        ``ml_dtypes.bfloat16`` array): its bits are taken as they are."""
        device = resolve(device)

        def t(x, dtype):
            return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
        if groups_bf is not None and not isinstance(groups_bf, torch.Tensor):
            bits = np.ascontiguousarray(groups_bf).view(np.int16)
            groups_bf = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return DenseBVH(
            nodes16=t(nodes16, np.float32), groups=t(groups, np.float32),
            inst16=t(inst16, np.float32), prim_base=t(prim_base, np.int32),
            world_lo=t(world_lo, np.float32), world_hi=t(world_hi, np.float32),
            stack_need=stack_need(nodes16, inst16),
            groups_bf=None if groups_bf is None else groups_bf.to(device),
            glo=None if glo is None else t(glo, np.float32),
            pids_c=None if pids_c is None else t(pids_c, np.float32))

    def to(self, device) -> "DenseBVH":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def n_nodes(self) -> int:
        return self.nodes16.shape[0] // NODE_F

    @property
    def n_groups(self) -> int:
        return self.groups.shape[0] // GROUP_ROWS

    @property
    def n_instances(self) -> int:
        return self.inst16.shape[0] // INST_F

    @property
    def two_level(self) -> bool:
        return self.inst16.shape[0] >= INST_F


def _group_periods(pid_rows: torch.Tensor) -> torch.Tensor:
    """Replication period c of each group's prim-id row (G, 128), as
    ``_pack_groups_bf`` finds it: the smallest c | 128 the row repeats with."""
    c = torch.full((pid_rows.shape[0],), LEAF_W, dtype=torch.int64,
                   device=pid_rows.device)
    for p in (64, 32, 16, 8, 4, 2, 1):
        c[(pid_rows == pid_rows[:, :p].repeat(1, LEAF_W // p)).all(dim=1)] = p
    return c


def _leaf_records(groups: torch.Tensor) -> torch.Tensor:
    """Kernel B1's per-triangle leaf records (module docstring), (G*C, 12)
    f32, from the f32 groups table, on its device."""
    G = groups.shape[0] // GROUP_ROWS
    rows = groups.reshape(G, GROUP_ROWS, LEAF_W)
    c = _group_periods(rows[:, 9, :])
    C = int(c.max()) if G else 1
    slots = rows[:, :10, :C].transpose(1, 2)               # (G, C, 10)
    rec = torch.zeros((G, C, 12), dtype=torch.float32, device=groups.device)
    rec[:, :, 3] = -1.0
    live = torch.arange(C, device=groups.device)[None, :] < c[:, None]
    for dst, src in ((slice(0, 3), slice(0, 3)), (slice(3, 4), slice(9, 10)),
                     (slice(4, 7), slice(3, 6)), (slice(8, 11), slice(6, 9))):
        rec[:, :, dst] = torch.where(live[:, :, None], slots[:, :, src], rec[:, :, dst])
    return rec.reshape(G * C, 12)


def _band_pairs(groups_bf: torch.Tensor) -> torch.Tensor:
    """Kernel B2's band pairs (module docstring): ``groups_bf`` (G*32, 128)
    as (G, 128, 32), each column's rows contiguous."""
    G = groups_bf.shape[0] // BF_ROWS
    return groups_bf.reshape(G, BF_ROWS, LEAF_W).transpose(1, 2).contiguous()


class TLASMeta(NamedTuple):
    """Host-side constants of a two-level build: what ``refresh_tlas``
    needs to rewrite the TLAS without touching BLAS or group data.
    ``blas_need`` (port-only) is each mesh's BLAS stack need (the deepest
    path from its root, the root counted as 1), so that a refresh counts
    ``stack_need`` from the new TLAS head alone."""

    tlas_cap: int
    inst_mesh: np.ndarray   # (I,) mesh index per instance
    blas_root: np.ndarray   # (B,) merged-table root node per mesh
    blas_lo: np.ndarray     # (B, 3) object-space root bounds per mesh
    blas_hi: np.ndarray     # (B, 3)
    blas_need: np.ndarray   # (B,) i64


def _surface_area(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                  + e[..., 2] * e[..., 0])


def _build_core(tri: np.ndarray, leaf_target: int):
    """Binned-SAH build with fat dense leaves: a segment becomes a leaf group
    once count <= leaf_target. Returns (nodes (n,16), leaf_segments, depth,
    root_lo, root_hi)."""
    T = tri.shape[0]
    leaf_target = min(leaf_target, LEAF_W)

    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    centroid = (bmin + bmax) * 0.5
    order = np.arange(T, dtype=np.int64)

    max_nodes = max(4 * (T // max(leaf_target // 4, 1) + 2), 8)
    nodes = np.zeros((max_nodes, NODE_F), np.float32)
    nodes[:, 12:14] = ABSENT
    n_nodes = 1
    leaf_segments: list[np.ndarray] = []

    def seg_bounds(seg):
        return bmin[seg].min(axis=0), bmax[seg].max(axis=0)

    def make_leaf(parent, side, s, e):
        g = len(leaf_segments)
        seg = order[s:e].copy()
        leaf_segments.append(seg)
        log2c = max(int(np.ceil(np.log2(max(len(seg), 1)))), 0)
        nodes[parent, 12 + side] = _tri_code(g, log2c)

    def choose_split(s, e):
        """Best binned-SAH split of order[s:e]; returns mid or None."""
        seg = order[s:e]
        c = centroid[seg]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        if not np.any(ext > 1e-12):
            return s + (e - s) // 2 if (e - s) > LEAF_W else None
        scale = np.where(ext > 1e-12, BINS * 0.9999 / np.where(ext > 0, ext, 1.0), 0.0)
        bin_id = np.clip(((c - cmin) * scale).astype(np.int32), 0, BINS - 1)
        # the three axes at once: bin b of axis a is row a * BINS + b
        keys = (bin_id + np.arange(0, 3 * BINS, BINS, dtype=np.int32)).reshape(-1)
        counts = np.bincount(keys, minlength=3 * BINS).reshape(3, BINS)
        bb_min = np.full((3 * BINS, 3), np.inf, np.float32)
        bb_max = np.full((3 * BINS, 3), -np.inf, np.float32)
        np.minimum.at(bb_min, keys, np.repeat(bmin[seg], 3, axis=0))
        np.maximum.at(bb_max, keys, np.repeat(bmax[seg], 3, axis=0))
        bb_min = bb_min.reshape(3, BINS, 3)
        bb_max = bb_max.reshape(3, BINS, 3)
        lmin = np.minimum.accumulate(bb_min, axis=1)
        lmax = np.maximum.accumulate(bb_max, axis=1)
        rmin = np.minimum.accumulate(bb_min[:, ::-1], axis=1)[:, ::-1]
        rmax = np.maximum.accumulate(bb_max[:, ::-1], axis=1)[:, ::-1]
        lcnt = np.cumsum(counts, axis=1)
        rcnt = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]
        la = _surface_area(lmin[:, :-1], lmax[:, :-1])
        ra = _surface_area(rmin[:, 1:], rmax[:, 1:])
        cost = la * lcnt[:, :-1] + ra * rcnt[:, 1:]
        cost = np.where((lcnt[:, :-1] == 0) | (rcnt[:, 1:] == 0) | (ext <= 1e-12)[:, None],
                        np.inf, cost)
        # the first axis, then the first bin, of the least finite cost
        k = int(np.argmin(cost))
        if not cost.flat[k] < np.inf:
            return s + (e - s) // 2 if (e - s) > LEAF_W else None
        ax, b = divmod(k, BINS - 1)
        go_left = bin_id[:, ax] <= b
        left = seg[go_left]
        right = seg[~go_left]
        if len(left) == 0 or len(right) == 0:
            return s + (e - s) // 2
        order[s:s + len(left)] = left
        order[s + len(left):e] = right
        return s + len(left)

    def alloc():
        nonlocal n_nodes
        i = n_nodes
        n_nodes += 1
        return i

    depth_max = 1
    stack = [(0, T, -1, -1, 1)]      # (start, end, parent, side, depth)
    while stack:
        s, e, parent, side, dep = stack.pop()
        depth_max = max(depth_max, dep)
        if (e - s) <= leaf_target:
            if parent < 0:
                lo, hi = seg_bounds(order[s:e])
                nodes[0, 0:3] = lo
                nodes[0, 3:6] = hi
                make_leaf(0, 0, s, e)
            else:
                make_leaf(parent, side, s, e)
            continue
        mid = choose_split(s, e)
        if mid is None or mid <= s or mid >= e:
            if parent < 0:
                lo, hi = seg_bounds(order[s:e])
                nodes[0, 0:3] = lo
                nodes[0, 3:6] = hi
                make_leaf(0, 0, s, e)
            else:
                make_leaf(parent, side, s, e)
            continue
        node = 0 if parent < 0 else alloc()
        if parent >= 0:
            nodes[parent, 12 + side] = float(node)
        lmin_, lmax_ = seg_bounds(order[s:mid])
        rmin_, rmax_ = seg_bounds(order[mid:e])
        nodes[node, 0:3] = lmin_
        nodes[node, 3:6] = lmax_
        nodes[node, 6:9] = rmin_
        nodes[node, 9:12] = rmax_
        stack.append((s, mid, node, 0, dep + 1))
        stack.append((mid, e, node, 1, dep + 1))

    if not all(len(s) <= LEAF_W for s in leaf_segments):
        raise AssertionError("a leaf exceeds one group")
    if int(np.rint(nodes[0, 13])) == ABSENT:      # single-leaf root
        root_lo, root_hi = nodes[0, 0:3].copy(), nodes[0, 3:6].copy()
    else:
        root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
        root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return nodes[:n_nodes], leaf_segments, depth_max, root_lo, root_hi


def _pack_groups(tri: np.ndarray, segments: list[np.ndarray]) -> np.ndarray:
    """Component-major leaf groups with cyclic power-of-two replication."""
    v0 = tri[:, 0]
    G = max(len(segments), 1)
    groups = np.zeros((G * GROUP_ROWS, LEAF_W), np.float32)
    groups[9::GROUP_ROWS, :] = -1.0   # prim row default: padding
    for g, seg in enumerate(segments):
        k = len(seg)
        r = g * GROUP_ROWS
        c = 1 << max(int(np.ceil(np.log2(max(k, 1)))), 0)
        data = np.zeros((10, c), np.float32)
        data[9, :] = -1.0
        p0 = v0[seg]
        data[0:3, :k] = p0.T
        data[3:6, :k] = (tri[seg, 1] - p0).T
        data[6:9, :k] = (tri[seg, 2] - p0).T
        data[9, :k] = seg.astype(np.float32)
        groups[r:r + 10, :] = np.tile(data, (1, LEAF_W // c))
    return groups


# single-level stub: shorter than one INST_F row, so the traversal runs
# without any instance machinery
_NO_INST = np.zeros((1,), np.float32)

# bf16 banded-group constants (the bf16 engine, ops/trace_bf16.py): 9
# geometry components x 2 bands (band 1 = band 0 pre-rolled by c/2), padded
# to 32 rows.
BF_BANDS = 2
BF_ROWS = 32
BF_USED = 9 * BF_BANDS


def _group_period(pid_row: np.ndarray) -> int:
    """Replication period c of one group's prim-id row (c | 128)."""
    for c in (1, 2, 4, 8, 16, 32, 64, 128):
        if np.array_equal(pid_row, np.tile(pid_row[:c], 128 // c)):
            return c
    return 128


def _pack_groups_bf(groups: np.ndarray):
    """The banded bf16 leaf table + per-group boxes + compact prim-id table,
    derived from the f32 component-major groups array (the period c is
    recovered from the prim-id row's replication pattern).

    Band b of component i sits at row BF_BANDS*i + b, pre-rolled right by
    (b*c)//BF_BANDS lanes: at sweep iteration k, ray lane l in band b
    tests original lane (l - k - (b*c)//BF_BANDS) mod 128 -- over
    k = 0..max(c/BF_BANDS,1)-1 the bands cover every distinct triangle of
    the group exactly (duplicates when c < BF_BANDS are harmless).

    Returns (groups_bf as a bf16 tensor, glo (G*8,) f32, pids_c (G*C,) f32).
    """
    G = groups.shape[0] // GROUP_ROWS
    gview = groups.reshape(G, GROUP_ROWS, LEAF_W)
    pidrow = gview[:, 9, :]                               # (G, 128)
    c_arr = np.full(G, LEAF_W, np.int64)
    for c in (64, 32, 16, 8, 4, 2, 1):
        eq = np.all(pidrow == np.tile(pidrow[:, :c], (1, LEAF_W // c)),
                    axis=1)
        c_arr[eq] = c
    comps = gview[:, 0:9, :].copy()                       # (G, 9, 128)
    v0 = comps[:, 0:3, :]
    corners = np.concatenate(
        [v0, v0 + comps[:, 3:6, :], v0 + comps[:, 6:9, :]], axis=2)
    live3 = np.tile(pidrow >= 0, (1, 3))[:, None, :]      # (G, 1, 384)
    lo = np.where(live3, corners, np.inf).min(axis=2)     # (G, 3)
    hi = np.where(live3, corners, -np.inf).max(axis=2)
    any_live = (pidrow >= 0).any(axis=1)[:, None]
    lo = np.where(any_live, lo, 0.0).astype(np.float32)
    hi = np.where(any_live, hi, 0.0).astype(np.float32)
    glo = np.zeros((G, 8), np.float32)     # [lo3, 0, hi3, 0] per group
    glo[:, 0:3] = lo
    glo[:, 4:7] = hi
    comps[:, 0:3, :] -= lo[:, :, None]                    # local v0
    out = np.zeros((G, BF_ROWS, LEAF_W), np.float32)
    lanes = np.arange(LEAF_W)
    for b in range(BF_BANDS):
        shift = (b * c_arr) // BF_BANDS                   # (G,)
        src = (lanes[None, None, :] - shift[:, None, None]) % LEAF_W
        out[:, BF_BANDS * np.arange(9) + b, :] = np.take_along_axis(
            comps, np.broadcast_to(src, comps.shape), axis=2)
    out_bf = torch.from_numpy(out.reshape(G * BF_ROWS, LEAF_W)).to(torch.bfloat16)
    C = int(c_arr.max()) if G else 1
    pids_c = np.where(np.arange(C)[None, :] < c_arr[:, None],
                      pidrow[:, :C], -1.0).astype(np.float32)
    return out_bf, glo.reshape(-1), pids_c.reshape(-1)


# Leaf shaping (CombineLeafs/SplitLeafs analogue) driven by the TPU kernel's
# cost model: a leaf visit costs a fixed overhead plus ceil_pow2(count) sweep
# iterations, a node step ~C_NODE of those units. Kept as is so the port
# builds the same tables; a cost model fitted to the GPU kernel is later work.
C_NODE = 1.5
C_LEAF = 3.0


def _pow2(k: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(k, 1)))), 0)


def _sa(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0]))


def dense_sweep_cost(nodes: np.ndarray, segments: list[np.ndarray],
                     bmin: np.ndarray, bmax: np.ndarray) -> float:
    """Expected sweep units per root-entering ray under the SAH area measure.
    ``bmin``/``bmax`` are accepted for signature parity and unused."""
    del bmin, bmax
    root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
    root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return _cost_walk(nodes, segments, _sa(root_lo, root_hi))


def _cost_walk(nodes, segments, area_root):
    """Sum over nodes/leaves of P(visit) * step cost (iterative)."""
    total = 0.0
    stack = [(0, None)]
    while stack:
        i, box = stack.pop()
        if box is None:
            lo = np.minimum(nodes[i, 0:3], nodes[i, 6:9])
            hi = np.maximum(nodes[i, 3:6], nodes[i, 9:12])
        else:
            lo, hi = box
        total += C_NODE * _sa(lo, hi) / area_root
        for side in range(2):
            code = int(np.rint(nodes[i, 12 + side]))
            if code == ABSENT:
                continue
            clo = nodes[i, 6 * side:6 * side + 3]
            chi = nodes[i, 6 * side + 3:6 * side + 6]
            if code >= 0:
                stack.append((code, (clo, chi)))
            else:
                v = -(code + 1)
                if v % 2 == 1:
                    continue   # instance leaf: costed in its BLAS
                g = (v // 2) // 8
                total += (_sa(clo, chi) / area_root
                          * (C_LEAF + _pow2(len(segments[g]))))
    return total


def shape_dense_leaves(tri: np.ndarray, nodes: np.ndarray,
                       segments: list[np.ndarray], min_leaf: int = 24,
                       hysteresis: float = 0.9,
                       ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Cost-driven leaf merge/split post-pass. Exact: traversal results are
    unchanged for any tree shape; only the expected sweep cost moves."""
    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)

    def seg_bounds(seg):
        return bmin[seg].min(axis=0), bmax[seg].max(axis=0)

    def decode(i):
        node = {"kind": "node"}
        for side in range(2):
            code = int(np.rint(nodes[i, 12 + side]))
            if code == ABSENT:
                node[f"c{side}"] = None
            elif code >= 0:
                node[f"c{side}"] = decode(code)
            else:
                v = -(code + 1)
                if v % 2 == 1:
                    node[f"c{side}"] = {"kind": "inst", "iid": v // 2}
                else:
                    g = (v // 2) // 8
                    node[f"c{side}"] = {"kind": "leaf",
                                        "seg": segments[g].copy()}
        return node

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    root = decode(0)

    def merge(nd):
        if nd is None or nd["kind"] != "node":
            return nd
        nd["c0"] = merge(nd["c0"])
        nd["c1"] = merge(nd["c1"])
        a, b = nd["c0"], nd["c1"]
        if (a is not None and b is not None
                and a["kind"] == "leaf" and b["kind"] == "leaf"
                and len(a["seg"]) + len(b["seg"]) <= LEAF_W):
            la, ha = seg_bounds(a["seg"])
            lb, hb = seg_bounds(b["seg"])
            lu = np.minimum(la, lb)
            hu = np.maximum(ha, hb)
            sa_u = max(_sa(lu, hu), 1e-30)
            pa = min(_sa(la, ha) / sa_u, 1.0)
            pb = min(_sa(lb, hb) / sa_u, 1.0)
            cost_split = (C_NODE + pa * (C_LEAF + _pow2(len(a["seg"])))
                          + pb * (C_LEAF + _pow2(len(b["seg"]))))
            cost_merged = C_LEAF + _pow2(len(a["seg"]) + len(b["seg"]))
            if cost_merged < cost_split:
                return {"kind": "leaf",
                        "seg": np.concatenate([a["seg"], b["seg"]])}
        return nd

    root = merge(root)

    def try_split(leaf):
        seg = leaf["seg"]
        k = len(seg)
        if k < 2 * min_leaf:
            return leaf
        lo, hi = seg_bounds(seg)
        centroid = (bmin[seg] + bmax[seg]) * 0.5
        ax = int(np.argmax(hi - lo))
        order = seg[np.argsort(centroid[:, ax], kind="stable")]
        m = k // 2
        a, b = order[:m], order[m:]
        la, ha = seg_bounds(a)
        lb, hb = seg_bounds(b)
        sa_u = max(_sa(lo, hi), 1e-30)
        pa = min(_sa(la, ha) / sa_u, 1.0)
        pb = min(_sa(lb, hb) / sa_u, 1.0)
        cost_split = (C_NODE + pa * (C_LEAF + _pow2(len(a)))
                      + pb * (C_LEAF + _pow2(len(b))))
        if cost_split < hysteresis * (C_LEAF + _pow2(k)):
            return {"kind": "node",
                    "c0": try_split({"kind": "leaf", "seg": a}),
                    "c1": try_split({"kind": "leaf", "seg": b})}
        return leaf

    def split_all(nd):
        if nd is None:
            return None
        if nd["kind"] == "leaf":
            return try_split(nd)
        if nd["kind"] == "node":
            nd["c0"] = split_all(nd["c0"])
            nd["c1"] = split_all(nd["c1"])
        return nd

    root = split_all(root)

    new_segments: list[np.ndarray] = []
    out_nodes: list[np.ndarray] = []

    def subtree_bounds(nd):
        """The box of ``nd``'s triangles, kept in ``nd`` once found."""
        if "box" in nd:
            return nd["box"]
        if nd["kind"] == "leaf":
            nd["box"] = seg_bounds(nd["seg"])
            return nd["box"]
        if nd["kind"] == "inst":
            raise AssertionError("shape_dense_leaves runs on single BLAS trees")
        los, his = [], []
        for side in range(2):
            ch = nd[f"c{side}"]
            if ch is not None:
                lo, hi = subtree_bounds(ch)
                los.append(lo)
                his.append(hi)
        nd["box"] = np.min(los, axis=0), np.max(his, axis=0)
        return nd["box"]

    def emit(nd):
        """Returns the child code for nd, emitting nodes as needed."""
        if nd["kind"] == "leaf":
            g = len(new_segments)
            new_segments.append(nd["seg"])
            log2c = max(int(np.ceil(np.log2(max(len(nd["seg"]), 1)))), 0)
            return _tri_code(g, log2c)
        idx = len(out_nodes)
        row = np.zeros(NODE_F, np.float32)
        row[12:14] = ABSENT
        out_nodes.append(row)
        for side in range(2):
            ch = nd[f"c{side}"]
            if ch is None:
                continue
            lo, hi = subtree_bounds(ch)
            row[6 * side:6 * side + 3] = lo
            row[6 * side + 3:6 * side + 6] = hi
            row[12 + side] = emit(ch)
        return float(idx)

    if root["kind"] == "leaf":
        lo, hi = seg_bounds(root["seg"])
        row = np.zeros(NODE_F, np.float32)
        row[0:3] = lo
        row[3:6] = hi
        row[12:14] = ABSENT
        out_nodes.append(row)
        g = len(new_segments)
        new_segments.append(root["seg"])
        log2c = max(int(np.ceil(np.log2(max(len(root["seg"]), 1)))), 0)
        row[12] = _tri_code(g, log2c)
    else:
        emit(root)
    return np.stack(out_nodes), new_segments


def _build_core_hq(tri: np.ndarray, leaf_target: int):
    """SBVH build of the dense-leaf tree via the native spatial-split
    builder (bvh/csrc/sbvh_builder.cpp, BuildHQ analogue), with
    _build_core's return contract; raises where the builder cannot run."""
    from physically_based_ray_tracer_tpu_torch.bvh import native

    nodes_box, children, segments = native.build_sbvh_generic(
        tri, min(leaf_target, LEAF_W), dense_mode=True)
    N = nodes_box.shape[0]
    INT32_MIN = np.iinfo(np.int32).min

    nodes = np.zeros((N, NODE_F), np.float32)
    nodes[:, 0:12] = nodes_box
    for n in range(N):
        for side in range(2):
            c = int(children[n, side])
            if c >= 0:
                nodes[n, 12 + side] = float(c)
            elif c == INT32_MIN:
                nodes[n, 12 + side] = ABSENT
            else:
                s = -(c + 1)
                log2c = max(int(np.ceil(np.log2(max(len(segments[s]), 1)))), 0)
                nodes[n, 12 + side] = _tri_code(s, log2c)

    # depth + root bounds by walking the tree
    depth = 1
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        depth = max(depth, d)
        for side in range(2):
            c = int(children[n, side])
            if c >= 0:
                stack.append((c, d + 1))
    if int(children[0, 1]) == INT32_MIN:   # single-leaf root
        root_lo, root_hi = nodes[0, 0:3].copy(), nodes[0, 3:6].copy()
    else:
        root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
        root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    return nodes, segments, depth, root_lo, root_hi


def _build_core_any(tri: np.ndarray, leaf_target: int, hq: bool = False,
                    shape: bool = False):
    out = _build_core_hq(tri, leaf_target) if hq else _build_core(tri, leaf_target)
    if shape:
        nodes, segments, depth, lo, hi = out
        nodes, segments = shape_dense_leaves(tri, nodes, segments)
        depth = _tree_depth(nodes)
        out = (nodes, segments, depth, lo, hi)
    return out


def _tree_depth(nodes: np.ndarray) -> int:
    depth = 1
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        depth = max(depth, d)
        for side in range(2):
            c = int(np.rint(nodes[n, 12 + side]))
            if c >= 0:
                stack.append((c, d + 1))
    return depth


def build_dense(triangles: np.ndarray, leaf_target: int = 64,
                hq: bool = False, shape: bool = False) -> tuple[DenseBVH, int]:
    """Single-level build over one triangle soup (prim ids global).

    hq=True uses the native SBVH core (spatial splits, BuildHQ analogue).
    shape=True runs the cost-driven leaf merge/split post-pass. Returns
    (DenseBVH on the CPU, depth)."""
    tri = np.asarray(triangles, np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    nodes, segments, depth, root_lo, root_hi = _build_core_any(
        tri, leaf_target, hq, shape)
    _check_codes(nodes.shape[0], len(segments))
    groups = _pack_groups(tri, segments)
    gbf, glo, pids_c = _pack_groups_bf(groups)
    dbvh = DenseBVH.from_numpy(nodes.reshape(-1), groups, _NO_INST,
                               np.zeros((1,), np.int32), root_lo, root_hi,
                               groups_bf=gbf, glo=glo, pids_c=pids_c,
                               device="cpu")   # host tables; the scene moves them
    return dbvh, depth


def _instance_aabbs(meta_lo, meta_hi, inst_mesh, transforms):
    """World AABB per instance: transform the 8 corners of the BLAS root box."""
    I = len(inst_mesh)
    lo = np.empty((I, 3), np.float32)
    hi = np.empty((I, 3), np.float32)
    for i, m in enumerate(inst_mesh):
        bl, bh = meta_lo[m], meta_hi[m]
        cs = np.array([[x, y, z] for x in (bl[0], bh[0])
                       for y in (bl[1], bh[1]) for z in (bl[2], bh[2])],
                      np.float32)
        w = cs @ transforms[i][:3, :3].T + transforms[i][:3, 3]
        lo[i] = w.min(axis=0)
        hi[i] = w.max(axis=0)
    return lo, hi


def _build_tlas_nodes(lo: np.ndarray, hi: np.ndarray, cap: int) -> np.ndarray:
    """Sweep-SAH BVH2 over instance AABBs; leaves are instance codes."""
    I = lo.shape[0]
    nodes = np.zeros((cap, NODE_F), np.float32)
    nodes[:, 12:14] = ABSENT
    cent = (lo + hi) * 0.5
    n_nodes = [1]

    def alloc():
        i = n_nodes[0]
        n_nodes[0] += 1
        return i

    def set_child(node, side, idx):
        part_lo = lo[idx].min(axis=0)
        part_hi = hi[idx].max(axis=0)
        nodes[node, 6 * side:6 * side + 3] = part_lo
        nodes[node, 6 * side + 3:6 * side + 6] = part_hi
        if len(idx) == 1:
            nodes[node, 12 + side] = _inst_code(int(idx[0]))
        else:
            c = alloc()
            nodes[node, 12 + side] = float(c)
            split(idx, c)

    def split(idx, node):
        best = None
        for ax in range(3):
            o = idx[np.argsort(cent[idx, ax], kind="stable")]
            lmin = np.minimum.accumulate(lo[o], axis=0)
            lmax = np.maximum.accumulate(hi[o], axis=0)
            rmin = np.minimum.accumulate(lo[o][::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(hi[o][::-1], axis=0)[::-1]
            k = np.arange(1, len(o))
            cost = (_surface_area(lmin[:-1], lmax[:-1]) * k
                    + _surface_area(rmin[1:], rmax[1:]) * (len(o) - k))
            b = int(np.argmin(cost))
            if best is None or cost[b] < best[0]:
                best = (float(cost[b]), o, b + 1)
        _, o, m = best
        set_child(node, 0, o[:m])
        set_child(node, 1, o[m:])

    if I == 1:
        set_child(0, 0, np.array([0]))
    else:
        split(np.arange(I), 0)
    if n_nodes[0] > cap:
        raise AssertionError("TLAS outgrew its reserved head")
    return nodes


def _inst_rows(inst_mesh, transforms, blas_root):
    I = len(inst_mesh)
    inst16 = np.zeros((I, INST_F), np.float32)
    for i, m in enumerate(inst_mesh):
        inv = np.linalg.inv(np.asarray(transforms[i], np.float64))
        inst16[i, 0:12] = inv[:3, :4].astype(np.float32).reshape(-1)
        inst16[i, 12] = float(blas_root[m])
    return inst16


def _build_blas(tri, leaf_target: int, hq: bool, shape: bool):
    """One mesh's BLAS and leaf tables: (nodes, depth, stack need from its
    root, root lo, root hi, glo, pids_c as (G, C), the groups' used rows and
    ``groups_bf``'s (as int16 bits), each in its first C lanes). C is the
    mesh's largest group period; every row of a group repeats with the
    group's period, which divides C, so tiling the C lanes gives the 128
    (``_expand``); at C = 16 a worker sends 1/13 of the table's bytes."""
    tri = np.asarray(tri, np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    nodes, segments, dep, rlo, rhi = _build_core_any(tri, leaf_target, hq, shape)
    groups = _pack_groups(tri, segments)
    gbf, glo, pids_c = _pack_groups_bf(groups)
    G = groups.shape[0] // GROUP_ROWS
    C = pids_c.shape[0] // G
    rows = groups.reshape(G, GROUP_ROWS, LEAF_W)[:, :GROUP_USED, :C]
    bf_rows = gbf.view(torch.int16).numpy().reshape(G, BF_ROWS, LEAF_W)[:, :BF_USED, :C]
    return (nodes, dep, _walk_need(nodes, 0), rlo, rhi, glo, pids_c.reshape(G, C),
            rows.copy(), bf_rows.copy())


def _expand(out: np.ndarray, start: int, rows: np.ndarray) -> None:
    """Writes a mesh's (G, R, C) compact rows, tiled to 128 lanes, into
    rows 0..R-1 of groups ``start``.. of ``out`` (n, rows, 128)."""
    out[start:start + rows.shape[0], :rows.shape[1]] = np.tile(
        rows, (1, 1, LEAF_W // rows.shape[2]))


def _blas_workers(mesh_tris: list) -> int:
    """Worker processes for the BLAS builds of ``mesh_tris``: the cores this
    process may run on, or 0 (build here) below PARALLEL_MIN_MESHES meshes
    or PARALLEL_MIN_TRIS triangles."""
    tris = sum(np.asarray(t).size // 9 for t in mesh_tris)
    if len(mesh_tris) < PARALLEL_MIN_MESHES or tris < PARALLEL_MIN_TRIS:
        return 0
    n = min(len(os.sched_getaffinity(0)), len(mesh_tris))
    return n if n > 1 else 0


def _build_blases(mesh_tris: list, leaf_target: int, hq: bool, shape: bool,
                  workers: int) -> list:
    """``_build_blas`` of every mesh, in order: here, or in ``workers``
    spawned processes (never forked: the caller may hold a CUDA context) of
    one torch thread each (the workers fill the cores), each task a run of
    consecutive meshes. As with any spawned pool, a script that builds such
    a table keeps its work under ``if __name__ == "__main__":``."""
    args = [mesh_tris] + [[x] * len(mesh_tris) for x in (leaf_target, hq, shape)]
    if not workers:
        return list(map(_build_blas, *args))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(1,)) as pool:
        run = -(-len(mesh_tris) // (workers * TASKS_PER_WORKER))
        return list(pool.map(_build_blas, *args, chunksize=run))


def build_dense_tlas(mesh_tris: list[np.ndarray], inst_mesh, transforms,
                     leaf_target: int = 64, hq: bool = False,
                     shape: bool = False, workers: int | str = "auto",
                     ) -> tuple[DenseBVH, TLASMeta, int]:
    """Two-level build: one shared BLAS per mesh + TLAS over instances.

    mesh_tris: per-mesh (T, 3, 3) object-space triangles; inst_mesh: (I,)
    mesh index per instance; transforms: (I, 4, 4) world-from-object.
    hq=True builds each BLAS with the native SBVH core. ``workers``: the
    processes that build the BLASes, 0 to build them here, "auto" for
    ``_blas_workers`` (workers for large tables only); the count goes to the
    innermost open span as ``workers``. Returns (DenseBVH, TLASMeta,
    depth)."""
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    I = len(inst_mesh)
    B = len(mesh_tris)
    tlas_cap = max(I - 1, 1)

    if workers == "auto":
        workers = _blas_workers(mesh_tris)
    elif isinstance(workers, str) or workers < 0:
        raise ValueError(f"workers must be a count >= 0 or 'auto', not {workers!r}")
    add_attrs(workers=workers)
    (blas_nodes, blas_depth, blas_need, blas_lo, blas_hi, blas_glo, blas_pids, blas_rows,
     blas_bf) = map(list, zip(*_build_blases(mesh_tris, leaf_target, hq, shape, workers)))
    depth_blas = max([1] + blas_depth)
    blas_lo = np.stack(blas_lo)
    blas_hi = np.stack(blas_hi)

    node_off = np.empty(B, np.int64)
    group_off = np.empty(B, np.int64)
    n = tlas_cap
    g = 0
    for b in range(B):
        node_off[b] = n
        group_off[b] = g
        n += blas_nodes[b].shape[0]
        g += blas_pids[b].shape[0]
    _check_codes(n, g)

    merged = []
    for b in range(B):
        nn = blas_nodes[b].copy()
        for k in (12, 13):
            col = np.rint(nn[:, k]).astype(np.int64)
            internal = col >= 0
            out = col.copy()
            out[internal] = col[internal] + node_off[b]
            leaf = (col < 0) & (col != ABSENT)
            v = -(col[leaf] + 1)
            g8l = v // 2
            regrouped = (g8l // 8 + group_off[b]) * 8 + g8l % 8
            out[leaf] = -(2 * regrouped + 1)
            nn[:, k] = out.astype(np.float32)
        merged.append(nn)

    inst16 = _inst_rows(inst_mesh, transforms, node_off)
    lo, hi = _instance_aabbs(blas_lo, blas_hi, inst_mesh, transforms)
    tlas = _build_tlas_nodes(lo, hi, tlas_cap)

    all_nodes = np.concatenate([tlas] + merged, axis=0)
    all_groups = np.zeros((g, GROUP_ROWS, LEAF_W), np.float32)
    gbf = np.zeros((g, BF_ROWS, LEAF_W), np.int16)
    for b in range(B):
        _expand(all_groups, group_off[b], blas_rows[b])
        _expand(gbf, group_off[b], blas_bf[b])
    del blas_rows, blas_bf
    C = max(p.shape[1] for p in blas_pids)
    pids_c = np.concatenate([np.pad(p, ((0, 0), (0, C - p.shape[1])), constant_values=-1.0)
                             for p in blas_pids]).reshape(-1)

    counts = np.array([mesh_tris[m].reshape(-1, 3, 3).shape[0]
                       if np.asarray(mesh_tris[m]).ndim == 3
                       else np.asarray(mesh_tris[m]).shape[0] // 3
                       for m in inst_mesh], np.int64)
    prim_base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)

    meta = TLASMeta(tlas_cap=tlas_cap, inst_mesh=inst_mesh,
                    blas_root=node_off.copy(), blas_lo=blas_lo,
                    blas_hi=blas_hi, blas_need=np.array(blas_need, np.int64))
    dbvh = DenseBVH.from_numpy(all_nodes.reshape(-1), all_groups.reshape(-1, LEAF_W),
                               inst16.reshape(-1), prim_base,
                               lo.min(axis=0), hi.max(axis=0),
                               groups_bf=torch.from_numpy(gbf.reshape(-1, LEAF_W)).view(torch.bfloat16),
                               glo=np.concatenate(blas_glo),
                               pids_c=pids_c, device="cpu")   # host tables; the scene moves them
    depth = tlas_cap.bit_length() + depth_blas + 2
    return dbvh, meta, depth


def refresh_tlas(dbvh: DenseBVH, meta: TLASMeta, transforms) -> DenseBVH:
    """The two-level table after instance transform changes: a new
    ``DenseBVH`` whose ``nodes16`` has only its TLAS head (``tlas_cap``
    nodes) rebuilt, with new ``inst16``, ``world_lo``, ``world_hi`` and
    ``stack_need``; every BLAS-side tensor (``groups``, ``groups_bf``,
    ``glo``, ``pids_c``, ``prim_base``, ``leaf_rec``, ``groups_bf2``) is
    the same object as ``dbvh``'s. New tensors are written, never the old
    ones, so ``dbvh`` stays valid (a frame still queued on it, or a scene
    rendered again). ``stack_need`` comes from the new head and
    ``meta.blas_need``, as ``stack_need()`` counts it on the whole table."""
    transforms = np.asarray(transforms, np.float32)
    lo, hi = _instance_aabbs(meta.blas_lo, meta.blas_hi, meta.inst_mesh,
                             transforms)
    tlas = _build_tlas_nodes(lo, hi, meta.tlas_cap)
    inst16 = _inst_rows(meta.inst_mesh, transforms, meta.blas_root).reshape(-1)
    dev = dbvh.nodes16.device
    nodes16 = torch.cat([torch.from_numpy(tlas.reshape(-1)).to(dev),
                         dbvh.nodes16[meta.tlas_cap * NODE_F:]])
    need = _walk_need(tlas, 0, meta.blas_need[meta.inst_mesh])
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    return dataclasses.replace(dbvh, nodes16=nodes16, inst16=f32(inst16),
                               world_lo=f32(lo.min(axis=0)),
                               world_hi=f32(hi.max(axis=0)), stack_need=need)
