"""Host-side binned-SAH builder of the classic BVH; counterpart of ``physically_based_ray_tracer_tpu/bvh/builder.py``.

``build_bvh`` runs the native C++ builder (``bvh/native.py``) by default, as
the JAX package does, and raises where that cannot run: the numpy builder
below, a line-for-line copy of the JAX package's, gives other tables for the
same triangles (it splits leaves the C++ one keeps), so it runs only when
asked for with ``use_native=False``. Both return CPU tables; the scene
builders move them to the scene's device.

``build_bvh_hq`` (the spatial-split SBVH build, BuildHQ analogue) runs the
native SBVH builder (``bvh/csrc/sbvh_builder.cpp``) and raises where it
cannot run, where the JAX package returns None. ``optimize_bvh`` (tree
rotations) is numpy, line for line.
"""

from __future__ import annotations

import numpy as np

from physically_based_ray_tracer_tpu_torch.bvh import native
from physically_based_ray_tracer_tpu_torch.bvh.types import (BVHArrays,
                                                             LEAF_COUNT_MASK,
                                                             encode_leaf)

BINS = 8          # BVHBINS (Core/tiny_bvh.h:92-125)
C_TRAV = 1.0
C_INT = 1.0


def _surface_area(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def build_bvh(triangles: np.ndarray, leaf_size: int = 4,
              use_native: bool = True) -> BVHArrays:
    """Build from fat triangles ``(3*T, 3)`` (v0,v1,v2 per tri) or ``(T, 3, 3)``.

    Returns CPU BVHArrays with tris packed as (v0, e1, e2) rows, padded so
    every leaf can gather a full ``leaf_size`` rows safely."""
    if use_native:
        out = native.build_bvh_native(
            np.asarray(triangles, np.float32).reshape(-1, 3, 3), leaf_size)
        return BVHArrays.from_numpy(*out, device="cpu")
    tri = np.asarray(triangles, dtype=np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    T = tri.shape[0]
    if not 1 <= leaf_size <= LEAF_COUNT_MASK:
        raise ValueError(f"leaf_size {leaf_size} outside 1..{LEAF_COUNT_MASK}")

    v0 = tri[:, 0]
    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    centroid = (bmin + bmax) * 0.5

    order = np.arange(T, dtype=np.int64)

    # node scratch: grown lists, flattened at the end
    max_nodes = max(2 * T, 4)
    nodes_box = np.zeros((max_nodes, 12), dtype=np.float32)
    nodes_child = np.zeros((max_nodes, 2), dtype=np.int32)
    n_nodes = 1  # root reserved at 0

    # leaf bookkeeping: (start, count) into the final reordered prim array
    leaf_ranges: list[tuple[int, int]] = []
    leaf_slots: list[tuple[int, int]] = []   # (node, side) pointing at each leaf
    packed_cursor = 0

    def seg_bounds(seg):
        return bmin[seg].min(axis=0), bmax[seg].max(axis=0)

    def make_leaf(parent, side, s, e):
        nonlocal packed_cursor
        count = e - s
        first = packed_cursor
        # pad each leaf range up to leaf_size for fixed-width gathers
        leaf_ranges.append((s, e))
        leaf_slots.append((parent, side))
        packed_cursor += leaf_size
        nodes_child[parent, side] = encode_leaf(first, count)

    def split_segment(s, e):
        """Return (axis_mid, left_end) or None if the segment should be a leaf.

        Segments at or under ``leaf_size`` still evaluate the SAH cost
        comparison: a split happens when it is cheaper than the leaf
        (tiny_bvh.h:1893 termination)."""
        seg = order[s:e]
        count = e - s
        if count == 1:
            return None
        c = centroid[seg]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        if not np.any(ext > 1e-12):
            # all centroids identical: leaf if it fits, else median split
            return None if count <= leaf_size else (None, s + count // 2)

        # binned SAH over all 3 axes at once (tiny_bvh.h:1841-1934 algorithm)
        scale = np.where(ext > 1e-12, BINS * 0.9999 / np.where(ext > 0, ext, 1.0), 0.0)
        bin_id = np.clip(((c - cmin) * scale).astype(np.int32), 0, BINS - 1)  # (n,3)

        best = (np.inf, -1, -1)  # cost, axis, split_bin
        for ax in range(3):
            if ext[ax] <= 1e-12:
                continue
            ids = bin_id[:, ax]
            counts = np.bincount(ids, minlength=BINS)
            bb_min = np.full((BINS, 3), np.inf, np.float32)
            bb_max = np.full((BINS, 3), -np.inf, np.float32)
            np.minimum.at(bb_min, ids, bmin[seg])
            np.maximum.at(bb_max, ids, bmax[seg])
            # prefix (left) and suffix (right) sweeps
            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            # split after bin b: left bins [0..b], right bins [b+1..]
            la = _surface_area(lmin[:-1], lmax[:-1])
            ra = _surface_area(rmin[1:], rmax[1:])
            cost = la * lcnt[:-1] + ra * rcnt[1:]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            b = int(np.argmin(cost))
            if cost[b] < best[0]:
                best = (float(cost[b]), ax, b)

        if best[1] < 0:
            return None if count <= leaf_size else (None, s + count // 2)
        node_min, node_max = seg_bounds(seg)
        parent_area = _surface_area(node_min, node_max)
        leaf_cost = C_INT * parent_area * count
        split_cost = C_TRAV * parent_area + C_INT * best[0]
        if count <= leaf_size and split_cost >= leaf_cost:
            return None   # SAH termination: leaf is cheaper than splitting

        ax, b = best[1], best[2]
        go_left = bin_id[:, ax] <= b
        left = seg[go_left]
        right = seg[~go_left]
        if len(left) == 0 or len(right) == 0:
            return None if count <= leaf_size else (None, s + count // 2)
        order[s:s + len(left)] = left
        order[s + len(left):e] = right
        return (ax, s + len(left))

    # iterative build: stack of (start, end, parent, side); root handled first
    def alloc_node():
        nonlocal n_nodes
        i = n_nodes
        n_nodes += 1
        return i

    stack = [(0, T, -1, -1)]
    while stack:
        s, e, parent, side = stack.pop()
        sp = split_segment(s, e)
        if sp is None:
            if parent < 0:
                # whole scene fits a single leaf: synthesize a root with the
                # leaf in slot 0 and an empty slot 1
                node = 0
                nmin, nmax = seg_bounds(order[s:e])
                nodes_box[node, 0:3] = nmin
                nodes_box[node, 3:6] = nmax
                nodes_box[node, 6:9] = nmin
                nodes_box[node, 9:12] = nmax
                make_leaf(node, 0, s, e)
                nodes_child[node, 1] = encode_leaf(0, 0)
            else:
                make_leaf(parent, side, s, e)
            continue
        _, mid = sp
        node = 0 if parent < 0 else alloc_node()
        if parent >= 0:
            nodes_child[parent, side] = node
        lmin, lmax = seg_bounds(order[s:mid])
        rmin, rmax = seg_bounds(order[mid:e])
        nodes_box[node, 0:3] = lmin
        nodes_box[node, 3:6] = lmax
        nodes_box[node, 6:9] = rmin
        nodes_box[node, 9:12] = rmax
        # children re-enter split_segment so small segments still get the
        # SAH split-vs-leaf comparison instead of forced leaf creation
        stack.append((s, mid, node, 0))
        stack.append((mid, e, node, 1))

    # pack triangles leaf-contiguous with per-leaf padding
    P = packed_cursor if packed_cursor > 0 else leaf_size
    tris_packed = np.zeros((P, 9), dtype=np.float32)
    prim_index = np.full((P,), -1, dtype=np.int32)
    cursor = 0
    for (s, e) in leaf_ranges:
        seg = order[s:e]
        k = len(seg)
        tris_packed[cursor:cursor + k, 0:3] = v0[seg]
        tris_packed[cursor:cursor + k, 3:6] = tri[seg, 1] - v0[seg]
        tris_packed[cursor:cursor + k, 6:9] = tri[seg, 2] - v0[seg]
        prim_index[cursor:cursor + k] = seg
        cursor += leaf_size

    return BVHArrays.from_numpy(
        nodes_box[:n_nodes], nodes_child[:n_nodes], tris_packed, prim_index,
        device="cpu")


def build_bvh_hq(triangles: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """High-quality SBVH build (BuildHQ analogue, tiny_bvh.h:2027-2286):
    binned object SAH + overlap-gated spatial splits with triangle-slab
    clipping, in the native builder (bvh/csrc/sbvh_builder.cpp). Spatial
    splits may reference one triangle from several leaves: prim_index
    carries the duplicates, which the traversals handle as any other prim
    (same t). Returns CPU tables."""
    tri = np.asarray(triangles, dtype=np.float32)
    if tri.ndim == 2:
        tri = tri.reshape(-1, 3, 3)
    nodes_box, children, segments = native.build_sbvh_generic(tri, leaf_size,
                                                              dense_mode=False)

    nodes_child = np.zeros_like(children)
    cursor = 0
    starts = []
    for seg in segments:
        starts.append(cursor)
        cursor += leaf_size
    INT32_MIN = np.iinfo(np.int32).min
    for n in range(children.shape[0]):
        for side in range(2):
            c = int(children[n, side])
            if c >= 0:
                nodes_child[n, side] = c
            elif c == INT32_MIN:
                nodes_child[n, side] = encode_leaf(0, 0)
            else:
                s = -(c + 1)
                nodes_child[n, side] = encode_leaf(starts[s], len(segments[s]))

    P = max(cursor, leaf_size)
    tris_packed = np.zeros((P, 9), dtype=np.float32)
    prim_index = np.full((P,), -1, dtype=np.int32)
    v0 = tri[:, 0]
    for s, seg in enumerate(segments):
        k = len(seg)
        o = starts[s]
        tris_packed[o:o + k, 0:3] = v0[seg]
        tris_packed[o:o + k, 3:6] = tri[seg, 1] - v0[seg]
        tris_packed[o:o + k, 6:9] = tri[seg, 2] - v0[seg]
        prim_index[o:o + k] = seg
    return BVHArrays.from_numpy(nodes_box, nodes_child, tris_packed, prim_index,
                                device="cpu")


def bvh_depth(bvh: BVHArrays) -> int:
    """Max tree depth (validates the static traversal stack bound)."""
    child = bvh.nodes_child.cpu().numpy()
    depth = 0
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        depth = max(depth, d)
        for side in range(2):
            c = int(child[n, side])
            if c >= 0:
                stack.append((c, d + 1))
    return depth


def optimize_bvh(nodes_box: np.ndarray, nodes_child: np.ndarray,
                 passes: int = 4) -> int:
    """Greedy tree-rotation optimizer (the role of tinybvh's reinsertion
    ``Optimize``, Core/tiny_bvh.h:2286/:3078-3181, in its cheap classic
    form: Kensler-style rotations). For each internal node with an internal
    child, consider swapping the other child with one of that child's
    grandchildren; apply the rotation that most reduces the intermediate
    node's surface area (the only term the global SAH cost changes by).
    Mutates ``nodes_box``/``nodes_child`` (numpy) in place; traversal
    results are unchanged (same leaves, different interior grouping).
    Returns the number of rotations applied.
    """

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def slot_box(n, s):
        return (nodes_box[n, 6 * s:6 * s + 3].copy(),
                nodes_box[n, 6 * s + 3:6 * s + 6].copy())

    def set_slot(n, s, lo, hi):
        nodes_box[n, 6 * s:6 * s + 3] = lo
        nodes_box[n, 6 * s + 3:6 * s + 6] = hi

    applied = 0
    N = nodes_box.shape[0]
    for _ in range(passes):
        changed = 0
        # bottom-up order so child boxes are final before the parent looks
        for n in range(N - 1, -1, -1):
            for s in range(2):       # the internal child whose kids rotate
                c = int(nodes_child[n, s])
                if c < 0:
                    continue
                o = 1 - s            # the sibling to rotate down
                sib_lo, sib_hi = slot_box(n, o)
                g_lo0, g_hi0 = slot_box(c, 0)
                g_lo1, g_hi1 = slot_box(c, 1)
                cur = area(*slot_box(n, s))
                best_gain, best_g = 0.0, -1
                for g in range(2):
                    keep_lo = (g_lo1, g_lo0)[g]
                    keep_hi = (g_hi1, g_hi0)[g]
                    nlo = np.minimum(sib_lo, keep_lo)
                    nhi = np.maximum(sib_hi, keep_hi)
                    gain = cur - area(nlo, nhi)
                    if gain > best_gain + 1e-7:
                        best_gain, best_g = gain, g
                if best_g < 0:
                    continue
                g = best_g
                moved_code = int(nodes_child[c, g])
                moved_lo, moved_hi = slot_box(c, g)
                sib_code = int(nodes_child[n, o])
                # sibling moves down into c's slot g
                nodes_child[c, g] = sib_code
                set_slot(c, g, sib_lo, sib_hi)
                # grandchild moves up into n's slot o
                nodes_child[n, o] = moved_code
                set_slot(n, o, moved_lo, moved_hi)
                # refresh n's box of c
                klo, khi = slot_box(c, 1 - g)
                set_slot(n, s, np.minimum(sib_lo, klo),
                         np.maximum(sib_hi, khi))
                changed += 1
        applied += changed
        if changed == 0:
            break
    return applied
