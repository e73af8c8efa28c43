"""BVH refit for deformed geometry; counterpart of ``physically_based_ray_tracer_tpu/bvh/refit.py``.

Vertex deformation (cloth, skinned meshes, morphing) moves triangles without
changing topology: a refit rewrites the stored triangle data and recomputes
the node boxes bottom-up, with no re-split. It runs on the host (numpy, the
JAX package's code line for line, so both packages give the same bytes) and
returns new tables on the input's device:

  * ``refit_bvh``   - the classic 2-wide BVH (``bvh/types.py``);
  * ``refit_dense`` - a single-level dense-leaf table (``bvh/dense.py``);
    rigid instance motion on a two-level table is ``refresh_tlas``'s.

``refit_dense`` rebuilds every table the kernels read from the new
``groups``: the bf16 leaves, group boxes and prim ids by ``_pack_groups_bf``,
and the port's derived tables (B1's and B3's ``leaf_rec``, B2's
``groups_bf2``) by ``DenseBVH.__post_init__``. Carrying the old ones over
would leave the kernels tracing the old geometry while the plain versions,
which read ``groups``, trace the new.

Trees built with spatial splits refit conservatively: a duplicated
reference grows to its whole triangle's box.
"""

from __future__ import annotations

import numpy as np

from physically_based_ray_tracer_tpu_torch.bvh.dense import (GROUP_ROWS, NODE_F,
                                                             DenseBVH, _pack_groups_bf)
from physically_based_ray_tracer_tpu_torch.bvh.types import (LEAF_COUNT_BITS,
                                                             BVHArrays)


def _levels(children: np.ndarray):
    """Nodes grouped by depth (root first); children (N, 2) int codes with
    internal >= 0."""
    N = children.shape[0]
    depth = np.full(N, -1, np.int64)
    depth[0] = 0
    order = [np.array([0])]
    cur = np.array([0])
    while True:
        c = children[cur].reshape(-1)
        nxt = c[c >= 0].astype(np.int64)
        nxt = nxt[depth[nxt] < 0] if len(nxt) else nxt
        if len(nxt) == 0:
            break
        depth[nxt] = len(order)
        order.append(nxt)
        cur = nxt
    return order


def _tris(new_tris) -> np.ndarray:
    tri = np.asarray(new_tris, np.float32)
    return tri.reshape(-1, 3, 3) if tri.ndim == 2 else tri


def refit_bvh(bvh: BVHArrays, new_tris: np.ndarray) -> BVHArrays:
    """Refit a classic 2-wide BVH to deformed triangles ((T,3,3) or (3T,3),
    original prim order). Returns new BVHArrays on ``bvh``'s device (its
    Woop rows recomputed from the new triangles)."""
    tri = _tris(new_tris)
    children = bvh.nodes_child.cpu().numpy()
    prim_index = bvh.prim_index.cpu().numpy()
    nodes_box = np.array(bvh.nodes_box.cpu().numpy(), np.float32, copy=True)

    # rewrite packed triangle rows from the new positions
    pid = np.maximum(prim_index, 0)
    v0 = tri[pid, 0]
    packed = np.concatenate(
        [v0, tri[pid, 1] - v0, tri[pid, 2] - v0], axis=1).astype(np.float32)
    packed[prim_index < 0] = 0.0

    # per-row corner bounds (padding rows excluded via +-inf)
    c0 = packed[:, 0:3]
    c1 = packed[:, 0:3] + packed[:, 3:6]
    c2 = packed[:, 0:3] + packed[:, 6:9]
    row_lo = np.minimum(np.minimum(c0, c1), c2)
    row_hi = np.maximum(np.maximum(c0, c1), c2)
    row_lo[prim_index < 0] = np.inf
    row_hi[prim_index < 0] = -np.inf

    # bottom-up: leaves first, then internal unions, by depth levels
    levels = _levels(children)
    node_lo = np.empty((children.shape[0], 2, 3), np.float32)
    node_hi = np.empty((children.shape[0], 2, 3), np.float32)
    for lvl in reversed(levels):
        for side in (0, 1):
            code = children[lvl, side]
            leaf = code < 0
            m = -(code + 1)
            first = m >> LEAF_COUNT_BITS
            count = m & ((1 << LEAF_COUNT_BITS) - 1)
            if leaf.any():
                wmax = int(count[leaf].max())
                lo = np.full((len(lvl), 3), np.inf, np.float32)
                hi = np.full((len(lvl), 3), -np.inf, np.float32)
                for j in range(max(wmax, 0)):
                    rows = np.clip(first + j, 0, packed.shape[0] - 1)
                    take = leaf & (j < count)
                    lo[take] = np.minimum(lo[take], row_lo[rows[take]])
                    hi[take] = np.maximum(hi[take], row_hi[rows[take]])
                # empty leaves (count 0) keep a degenerate inverted box
                node_lo[lvl[leaf], side] = lo[leaf]
                node_hi[lvl[leaf], side] = hi[leaf]
            internal = ~leaf
            if internal.any():
                ci = code[internal].astype(np.int64)
                node_lo[lvl[internal], side] = np.minimum(
                    node_lo[ci, 0], node_lo[ci, 1])
                node_hi[lvl[internal], side] = np.maximum(
                    node_hi[ci, 0], node_hi[ci, 1])
    nodes_box[:, 0:3] = node_lo[:, 0]
    nodes_box[:, 3:6] = node_hi[:, 0]
    nodes_box[:, 6:9] = node_lo[:, 1]
    nodes_box[:, 9:12] = node_hi[:, 1]
    # empty leaf slots produced inverted inf boxes; store finite inverted
    # boxes instead (reject every ray without inf arithmetic)
    for cols in ([0, 1, 2, 6, 7, 8], [3, 4, 5, 9, 10, 11]):
        nodes_box[:, cols] = np.nan_to_num(nodes_box[:, cols], posinf=1e30,
                                           neginf=-1e30)
    return BVHArrays.from_numpy(nodes_box, children, packed, prim_index,
                                device=bvh.nodes_box.device)


def refit_dense(dbvh: DenseBVH, new_tris: np.ndarray) -> DenseBVH:
    """Refit a single-level dense-leaf table to deformed triangles (global
    prim order). Returns a new DenseBVH on ``dbvh``'s device whose bf16
    tables, ``leaf_rec``, ``groups_bf2`` and ``stack_need`` are all
    rebuilt from the refit ``groups`` and ``nodes16``."""
    tri = _tris(new_tris)
    if dbvh.n_instances != 0:
        raise AssertionError(
            "dense refit covers the single-level baked path; rigid instance "
            "motion goes through refresh_tlas instead")

    groups = np.array(dbvh.groups.cpu().numpy(), np.float32, copy=True)
    G = groups.shape[0] // GROUP_ROWS
    gview = groups.reshape(G, GROUP_ROWS, -1)
    pid = gview[:, 9, :].astype(np.int64)          # (G, 128)
    live = pid >= 0
    p = np.maximum(pid, 0)
    v0 = tri[p, 0]                                  # (G, 128, 3)
    e1 = tri[p, 1] - v0
    e2 = tri[p, 2] - v0
    for k in range(3):
        gview[:, 0 + k, :] = np.where(live, v0[..., k], 0.0)
        gview[:, 3 + k, :] = np.where(live, e1[..., k], 0.0)
        gview[:, 6 + k, :] = np.where(live, e2[..., k], 0.0)

    # per-group bounds over live lanes
    lo3 = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi3 = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    lo3 = np.where(live[..., None], lo3, np.inf)
    hi3 = np.where(live[..., None], hi3, -np.inf)
    g_lo = lo3.min(axis=1)                          # (G, 3)
    g_hi = hi3.max(axis=1)

    nodes = np.array(dbvh.nodes16.cpu().numpy(), np.float32, copy=True).reshape(-1, NODE_F)
    children = np.rint(nodes[:, 12:14]).astype(np.int64)
    levels = _levels(np.where(children >= 0, children, -1).astype(np.int32))
    # child code decode for leaves: v = -(code+1); tri leaf payload v>>1
    node_lo = np.empty((nodes.shape[0], 2, 3), np.float32)
    node_hi = np.empty((nodes.shape[0], 2, 3), np.float32)
    for lvl in reversed(levels):
        for side in (0, 1):
            code = children[lvl, side]
            internal = code >= 0
            v = -(code + 1)
            is_tri = ~internal & (v >= 0) & (v % 2 == 0)
            g = np.clip((v // 2) // 8, 0, G - 1)
            node_lo[lvl, side] = np.where(is_tri[:, None], g_lo[g], np.inf)
            node_hi[lvl, side] = np.where(is_tri[:, None], g_hi[g], -np.inf)
            if internal.any():
                ci = code[internal]
                node_lo[lvl[internal], side] = np.minimum(
                    node_lo[ci, 0], node_lo[ci, 1])
                node_hi[lvl[internal], side] = np.maximum(
                    node_hi[ci, 0], node_hi[ci, 1])
    nodes[:, 0:3] = node_lo[:, 0]
    nodes[:, 3:6] = node_hi[:, 0]
    nodes[:, 6:9] = node_lo[:, 1]
    nodes[:, 9:12] = node_hi[:, 1]
    nodes[:, 0:12] = np.nan_to_num(nodes[:, 0:12], posinf=1e30, neginf=-1e30)

    root_lo = np.minimum(nodes[0, 0:3], nodes[0, 6:9])
    root_hi = np.maximum(nodes[0, 3:6], nodes[0, 9:12])
    finite = lambda x: np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    gbf, glo, pids_c = _pack_groups_bf(groups)
    # from_numpy passes no derived table, so __post_init__ builds leaf_rec
    # and groups_bf2 from these groups, and stack_need is counted anew
    return DenseBVH.from_numpy(nodes.reshape(-1), groups, dbvh.inst16.cpu().numpy(),
                               dbvh.prim_base.cpu().numpy(), finite(root_lo),
                               finite(root_hi), groups_bf=gbf, glo=glo, pids_c=pids_c,
                               device=dbvh.nodes16.device)
