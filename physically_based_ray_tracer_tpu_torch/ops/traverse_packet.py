"""Wave traversal of the classic BVH (``traversal="wave"``); counterpart of the wave path of ``physically_based_ray_tracer_tpu/ops/traverse_packet.py``.

Rays are grouped into tiles of W; each TILE owns one cursor and one stack
over the classic 2-wide BVH (``bvh/types.py``) and culls nodes with a
conservative interval test of its origin box and direction bounds. The
engine iterates WAVES:

* ``node_steps`` node-only steps per tile, buffering up to ``leaf_cap``
  leaves (``ops/wave_scan.py``);
* one dense phase testing every ray of a tile against every triangle of
  its buffered leaves (kernel B4's function, ``ops/leaf_mt.py``, for
  ``dense="mt"``; ``dense="woop"`` runs the Woop transform in torch);
* the per-tile pruning distance and the active flags are updated.

An adaptive shrink cascade compacts the still-active tiles into a
1/``shrink``-wide array as soon as they fit, so total work tracks the sum
of per-tile visits, not T x (slowest tile). With ``dense="mt"`` a level's
waves run in ``ops/wave_level.py``: on the card one launch of the fused
kernel ``csrc/wave_level.cu`` per level, whose loop test runs on the card
(an engine call then has no host sync; the compaction between levels is
torch and needs none), on the CPU the plain per-wave loop. ``dense="woop"``
keeps the per-wave loop here: a launch of the scan kernel, the Woop phase
in torch and a host-read loop test per wave. ``WAVES`` (the dict of
``ops/wave_level.py``; on the card read through ``collect_waves``) counts
the waves run per mode, ``LEVELS`` the levels.

The packet engine (``traversal="packet"``, ``intersect_closest_packet`` /
``intersect_any_packet``) is the JAX module's older loop over the same tiles
and culling: one step per iteration, either one node or one leaf tested
densely against all W rays of the tile (``mt_dense``, then the ordered take
of ``leaf_mt.ordered_take``: the loop over the leaf's slots with a strict
``<`` keeps the first smallest t). Like the lane engine
(``ops/traverse.py``) it is torch, runs its loop in ``traverse.run_steps``
blocks (the test read every ``traverse.CHECK_EVERY`` steps, finished tiles
dropped, a CUDA graph a block on the card) and emulates the JAX stack's
overflow (``traverse.stack_step``); ``PACKET_STEPS`` counts its steps per
mode. Its miss record is its own: t starts at BVH_FAR whatever ``t_max``
is, a hit counts only below ``t_max``, and a miss gives t = BVH_FAR,
u = v = 0, prim = inst = -1.

Sorting rays by direction octant + origin Morton code (``sorted_closest``,
``sorted_any``) makes tiles coherent; ``morton_order`` takes
``morton_key``'s three modes (``ops/trace.py``). The JAX module's leaf math
(``mt_dense``, ``_leaf_columns``) lives beside kernel B4 in
``ops/leaf_mt.py`` (``_leaf_decode`` is ``bvh/types.py::decode_leaf``), its
``_interval_slab`` beside the scan kernel in ``ops/wave_scan.py``.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops import traverse, wave_level, wave_scan
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit, safe_rcp
from physically_based_ray_tracer_tpu_torch.ops.leaf_mt import (_gather_rows,
                                                               leaf_columns,
                                                               mt_dense,
                                                               ordered_take)
from physically_based_ray_tracer_tpu_torch.ops.trace import _unsort, morton_key
from physically_based_ray_tracer_tpu_torch.ops.wave_level import WAVES, _tile_update
from physically_based_ray_tracer_tpu_torch.ops.wave_scan import BIG, DONE, _interval_slab

LEVELS = {"closest": 0, "any": 0}
PACKET_STEPS = {"closest": 0, "any": 0}


def reset_counts() -> None:
    """Zeroes ``WAVES``, ``LEVELS``, ``PACKET_STEPS`` and
    ``ops/wave_level.py``'s counts."""
    wave_level.reset_counts()
    for d in (LEVELS, PACKET_STEPS):
        for k in d:
            d[k] = 0


def collect_waves() -> dict:
    """The waves run per mode since ``reset_counts``, on every device
    (synchronises)."""
    return wave_level.collect_waves()


def _tile_bounds(o, d):
    """Per-tile origin box + reciprocal-direction interval. o,d: (T, W, 3).

    The reciprocal of a direction interval [a, b] must respect the pole at 0:
      a > 0          -> [1/b, 1/a]
      b < 0          -> [1/b, 1/a]
      a == 0, b > 0  -> [1/b, +BIG]       (rays arbitrarily slow, same sign)
      a < 0, b == 0  -> [-BIG, 1/a]
      a < 0 < b      -> [-BIG, +BIG]      (mixed signs: no useful bound)
    """
    o_lo = torch.amin(o, dim=1)
    o_hi = torch.amax(o, dim=1)
    d_lo = torch.amin(d, dim=1)
    d_hi = torch.amax(d, dim=1)
    rd_a = safe_rcp(d_lo)
    rd_b = safe_rcp(d_hi)
    same_sign = (d_lo > 0.0) | (d_hi < 0.0)
    big = torch.full_like(d_lo, BIG)
    rd_lo = torch.where(same_sign, rd_b,
                        torch.where((d_lo == 0.0) & (d_hi > 0.0), rd_b, -big))
    rd_hi = torch.where(same_sign, rd_a,
                        torch.where((d_hi == 0.0) & (d_lo < 0.0), rd_a, big))
    return o_lo, o_hi, rd_lo, rd_hi


def _pad_tiles(o, d, extra, tile):
    b = o.shape[0]
    n_tiles = -(-b // tile)
    pad = n_tiles * tile - b
    # rays padded edge-mode (clones of the last ray) so the last tile's
    # conservative bounds aren't inflated; their t_max pads to 0 (inactive)
    edge = lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x
    o = edge(o).reshape(n_tiles, tile, 3)
    d = edge(d).reshape(n_tiles, tile, 3)
    extra = [torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
             for x in extra]
    extra = [x.reshape((n_tiles, tile) + x.shape[1:]) for x in extra]
    return o.contiguous(), d.contiguous(), extra, b, n_tiles


def _packet_tiles(bvh, o, d, t_max, tile, stack_depth):
    """The packet engine's padded tiles and tile state (one row per tile in
    each tensor), and the rays' count."""
    traverse.check_rays(bvh, o, d, t_max, "packet")
    o_t, d_t, (tmax_t,), b, T = _pad_tiles(o, d, [t_max], tile)
    cur, sp, stack = traverse.stack_state(T, stack_depth, o.device)
    o_lo, o_hi, rd_lo, rd_hi = _tile_bounds(o_t, d_t)
    return dict(o_t=o_t, d_t=d_t, tmax=tmax_t, o_lo=o_lo, o_hi=o_hi, rd_lo=rd_lo,
                rd_hi=rd_hi, cur=cur, sp=sp, stack=stack,
                active=torch.ones((T,), dtype=torch.bool, device=o.device)), b


def _tile_children(bvh, s, t_tile):
    """A node step of the tiles: (is_leaf, children (T, 2), entry (T, 2),
    may-hit (T, 2)) of their nodes (node 0 for a leaf or a finished tile),
    empty leaf slots rejected."""
    cur = s["cur"]
    is_leaf = cur < 0
    node_idx = torch.where(is_leaf | ~s["active"], 0, cur)
    box = _gather_rows(bvh.nodes_box, node_idx)               # (T, 12)
    child = _gather_rows(bvh.nodes_child, node_idx)           # (T, 2)
    bounds = (s["o_lo"], s["o_hi"], s["rd_lo"], s["rd_hi"])
    d0, h0 = _interval_slab(box[:, 0:6], *bounds, t_tile)
    d1, h1 = _interval_slab(box[:, 6:12], *bounds, t_tile)
    hit = torch.stack([h0, h1], dim=1) & ~traverse.empty_slot(child)
    return is_leaf, child, torch.stack([d0, d1], dim=1), hit


def intersect_closest_packet(bvh: BVHArrays, o, d, t_max=None, *,
                             tile: int = 256, stack_depth: int = 48,
                             leaf_size: int = 4) -> Hit:
    """Closest-hit packet traversal. o, d: (B, 3); returns per-ray Hit
    (prim in the scene's triangle order; the miss record of the module
    docstring)."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    st, b = _packet_tiles(bvh, o, d, t_max, tile, stack_depth)
    T, W = st["tmax"].shape
    dev = o.device
    # padded lanes have t_max 0: they never hit and never widen the pruning
    st.update(t=torch.full((T, W), BVH_FAR, dtype=o.dtype, device=dev),
              u=torch.zeros((T, W), dtype=o.dtype, device=dev),
              v=torch.zeros((T, W), dtype=o.dtype, device=dev),
              prim=torch.full((T, W), -1, dtype=torch.int32, device=dev))
    kk = torch.arange(leaf_size, dtype=torch.int32, device=dev)

    def body(s):
        cur, active = s["cur"], s["active"]
        clip = torch.minimum(s["t"], s["tmax"])
        t_tile = torch.amax(clip, dim=1)                          # (T,)
        is_leaf, child, dist, hit = _tile_children(bvh, s, t_tile)
        swap = dist[:, 1] < dist[:, 0]
        c0, c1 = child[:, 0], child[:, 1]
        near = torch.where(swap, c1, c0)
        far = torch.where(swap, c0, c1)
        near_hit = torch.where(swap, hit[:, 1], hit[:, 0])
        far_hit = torch.where(swap, hit[:, 0], hit[:, 1])
        internal_next = torch.where(near_hit, near,
                                    torch.where(far_hit, far, torch.full_like(far, DONE)))
        push = near_hit & far_hit & active & ~is_leaf
        # leaf: dense W x leaf_size Möller-Trumbore, then the ordered take
        _, count, slots, rows = traverse.leaf_slots(bvh, cur, is_leaf, leaf_size)
        kt, ku, kv, khit = mt_dense(s["o_t"], s["d_t"], rows, clip)
        valid = ((kk[None, :] < count[:, None]) & (is_leaf & active)[:, None])[:, None, :] & khit
        s["t"], s["u"], s["v"], s["prim"] = ordered_take(
            kt, ku, kv, valid, slots, s["t"], s["u"], s["v"], s["prim"], s["tmax"])
        nxt = torch.where(is_leaf, torch.full_like(cur, DONE), internal_next)
        nxt, s["sp"], exhausted = traverse.stack_step(s["stack"], s["sp"], nxt, push, far,
                                                      active)
        s["active"] = active & ~exhausted
        s["cur"] = torch.where(s["active"], nxt, torch.full_like(nxt, DONE))

    traverse.run_steps(body, st, ("t", "u", "v", "prim"), "closest", PACKET_STEPS)
    take = lambda x: x.reshape(-1)[:b]
    t, prim_slot = take(st["t"]), take(st["prim"])
    found = (prim_slot >= 0) & (t < t_max)
    prim = torch.where(found, _gather_rows(bvh.prim_index, prim_slot.clamp(min=0)), -1)
    zero = torch.zeros_like(t)
    return Hit(t=torch.where(found, t, torch.full_like(t, BVH_FAR)),
               u=torch.where(found, take(st["u"]), zero),
               v=torch.where(found, take(st["v"]), zero),
               prim=prim.to(torch.int32),
               inst=torch.where(found, 0, -1).to(torch.int32))


def intersect_any_packet(bvh: BVHArrays, o, d, t_max, *,
                         tile: int = 256, stack_depth: int = 48,
                         leaf_size: int = 4) -> torch.Tensor:
    """Occlusion packet query: True where a hit exists with t in (0, t_max).
    A tile retires once each of its rays is occluded or has t_max <= 0."""
    st, b = _packet_tiles(bvh, o, d, t_max, tile, stack_depth)
    st["occ"] = torch.zeros(st["tmax"].shape, dtype=torch.bool, device=o.device)
    kk = torch.arange(leaf_size, dtype=torch.int32, device=o.device)

    def body(s):
        cur, active, tmax = s["cur"], s["active"], s["tmax"]
        pending = ~s["occ"] & (tmax > 0.0)
        t_tile = torch.amax(torch.where(pending, tmax, 0.0), dim=1)
        is_leaf, child, _, hit = _tile_children(bvh, s, t_tile)
        h0, h1 = hit[:, 0], hit[:, 1]
        c0, c1 = child[:, 0], child[:, 1]
        internal_next = torch.where(h0, c0, torch.where(h1, c1, torch.full_like(c1, DONE)))
        push = h0 & h1 & active & ~is_leaf

        _, count, _, rows = traverse.leaf_slots(bvh, cur, is_leaf, leaf_size)
        khit = mt_dense(s["o_t"], s["d_t"], rows, tmax)[3]
        valid = ((kk[None, :] < count[:, None]) & (is_leaf & active)[:, None])[:, None, :] & khit
        s["occ"] = s["occ"] | torch.any(valid, dim=2)

        nxt = torch.where(is_leaf, torch.full_like(cur, DONE), internal_next)
        nxt, s["sp"], exhausted = traverse.stack_step(s["stack"], s["sp"], nxt, push, c1,
                                                      active)
        all_occluded = torch.all(s["occ"] | (tmax <= 0.0), dim=1)
        s["active"] = active & ~exhausted & ~all_occluded
        s["cur"] = torch.where(s["active"], nxt, torch.full_like(nxt, DONE))

    traverse.run_steps(body, st, ("occ",), "any", PACKET_STEPS)
    return st["occ"].reshape(-1)[:b]


def _w1_from_rows(rows_w, K_tot):
    """(T, K, 12) Woop rows -> (T, 4, 3K) matmul weights, columns grouped
    axis-major: [all-x | all-y | all-z] so the epilogue slices contiguously."""
    T = rows_w.shape[0]
    r = rows_w.reshape(T, K_tot, 3, 4)           # [j, axis, f]
    return r.permute(0, 3, 2, 1).reshape(T, 4, 3 * K_tot)


def woop_dense(o_t, d_t, w1, t_clip):
    """Dense tile x leaf intersection through per-triangle Woop transforms.

    o_t, d_t: (T, W, 3); w1: (T, 4, 3K) Woop weights; t_clip: (T, W).
    One batched product maps [o,1] and [d,0] of every lane through every
    triangle's unit-triangle transform; the epilogue is ~10 ops per pair.
    The JAX package leaves that product to XLA outside any Pallas kernel,
    so here it is ``torch.bmm`` in float32 (TF32 off, PyTorch's default for
    matrix products). Returns (t, u, v, hit) each (T, W, K).
    """
    T, W, _ = o_t.shape
    K = w1.shape[2] // 3
    ones = torch.ones((T, W, 1), dtype=o_t.dtype, device=o_t.device)
    zeros = torch.zeros_like(ones)
    feats = torch.cat([torch.cat([o_t, ones], dim=-1),
                       torch.cat([d_t, zeros], dim=-1)], dim=1)   # (T, 2W, 4)
    PQ = torch.bmm(feats, w1)                                       # (T, 2W, 3K)
    P, Q = PQ[:, :W], PQ[:, W:]
    px, py, pz = P[..., 0:K], P[..., K:2 * K], P[..., 2 * K:3 * K]
    qx, qy, qz = Q[..., 0:K], Q[..., K:2 * K], Q[..., 2 * K:3 * K]
    ok = torch.abs(qz) > 1e-12
    t = -pz / torch.where(ok, qz, torch.ones_like(qz))
    u = px + t * qx
    v = py + t * qy
    # small barycentric slack: the transform's rounding differs from MT's, so
    # exact-zero bounds would open cracks along shared edges
    eps = 1e-5
    hit = (ok & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
           & (t > 0.0) & (t < t_clip[:, :, None]))
    return t, u, v, hit


def _woop_slots_dense(bvh, o_t, d_t, slots, col_ok, t_clip):
    rows_w = _gather_rows(bvh.tris_woop, torch.where(col_ok, slots, 0))
    w1 = _w1_from_rows(rows_w, slots.shape[1])
    return woop_dense(o_t, d_t, w1, t_clip)


def _wave_state(o_t, d_t, tmax_t, stack_depth, closest):
    T, W, _ = o_t.shape
    dev = o_t.device
    o_lo, o_hi, rd_lo, rd_hi = _tile_bounds(o_t, d_t)
    i32 = dict(dtype=torch.int32, device=dev)
    st = dict(
        o_t=o_t, d_t=d_t, tmax=tmax_t.contiguous(),
        o_lo=o_lo, o_hi=o_hi, rd_lo=rd_lo, rd_hi=rd_hi,
        cur=torch.zeros((T,), **i32),
        sp=torch.zeros((T,), **i32),
        stack=torch.full((T, stack_depth), DONE, **i32),
        active=torch.ones((T,), dtype=torch.bool, device=dev),
        tile_id=torch.arange(T, **i32),
    )
    if closest:
        st.update(t=torch.full((T, W), BVH_FAR, dtype=o_t.dtype, device=dev),
                  u=torch.zeros((T, W), dtype=o_t.dtype, device=dev),
                  v=torch.zeros((T, W), dtype=o_t.dtype, device=dev),
                  prim=torch.full((T, W), -1, **i32))
        st["t_tile"] = torch.amax(torch.minimum(st["t"], st["tmax"]), dim=1)
    else:
        st["occ"] = torch.zeros((T, W), dtype=torch.bool, device=dev)
        st["t_tile"] = torch.amax(torch.where(st["tmax"] > 0.0, st["tmax"], 0.0), dim=1)
    return st


def _woop_phase(bvh, st, leafbuf, nleaf, *, closest, leaf_size):
    """The wave's dense phase for dense="woop": every ray of a tile against
    the triangles of its buffered leaves, through their Woop transforms."""
    slots, col_ok = leaf_columns(leafbuf, nleaf, leaf_size)
    if closest:
        t_clip = torch.minimum(st["t"], st["tmax"])
        kt, ku, kv, khit = _woop_slots_dense(bvh, st["o_t"], st["d_t"], slots,
                                             col_ok, t_clip)
        new = ordered_take(kt, ku, kv, khit & col_ok[:, None, :], slots,
                           st["t"], st["u"], st["v"], st["prim"], st["tmax"])
        st.update(zip(("t", "u", "v", "prim"), new))
    else:
        _, _, _, khit = _woop_slots_dense(bvh, st["o_t"], st["d_t"], slots,
                                          col_ok, st["tmax"])
        st["occ"] = st["occ"] | torch.any(khit & col_ok[:, None, :], dim=2)
    return st


def _wave_run(bvh, st, *, closest, node_steps, leaf_cap, leaf_size, dense,
              min_active):
    """while(any active [and > min_active tiles active]): node scan + dense.

    ``min_active`` is the adaptive-cascade exit: once at most that many
    tiles remain active, control returns so the caller can compact them
    into a narrower array (guaranteed to fit) and keep iterating there.
    dense="mt": one ``wave_level.run_level`` launch on the card, the plain
    loop on the CPU; dense="woop": the per-wave loop below."""
    mode = "closest" if closest else "any"
    LEVELS[mode] += 1
    if dense == "mt":
        kw = dict(closest=closest, node_steps=node_steps, leaf_cap=leaf_cap,
                  leaf_size=leaf_size, min_active=min_active)
        if st["cur"].device.type == "cpu":
            return wave_level.plain_run_level(bvh, st, **kw)
        return wave_level.run_level(bvh, st, **kw)
    while (int(st["active"].sum()) > min_active if min_active
           else bool(st["active"].any())):
        _, _, _, nleaf, leafbuf, _ = wave_scan.node_scan(bvh, st, node_steps, leaf_cap)
        st = _woop_phase(bvh, st, leafbuf, nleaf, closest=closest, leaf_size=leaf_size)
        st = _tile_update(st, closest=closest)
        WAVES[mode] += 1
    return st


def _take_rows(st: dict, idx) -> dict:
    return {k: v[idx] for k, v in st.items()}


def _wave_engine(bvh, o, d, t_max, *, closest, tile, stack_depth, leaf_size,
                 node_steps, leaf_cap, dense, shrink):
    """Adaptive shrink cascade.

    Each level of width T_k iterates while more than T_k/shrink tiles are
    active, then stable-sorts actives to the front and continues in a
    T_k/shrink-wide array: the exit condition guarantees every active tile
    fits, so no backstop pass is needed."""
    if dense not in ("mt", "woop"):
        raise ValueError(f"dense={dense!r}: 'mt' or 'woop'")
    o_t, d_t, (tmax_t,), b, T = _pad_tiles(o, d, [t_max], tile)
    st = _wave_state(o_t, d_t, tmax_t, stack_depth, closest)
    run = lambda s, min_active: _wave_run(
        bvh, s, closest=closest, node_steps=node_steps, leaf_cap=leaf_cap,
        leaf_size=leaf_size, dense=dense, min_active=min_active)

    segments = []
    T_k = T
    shrunk = shrink and shrink > 1
    while shrunk and T_k // shrink >= 16:
        st = run(st, T_k // shrink)
        order = torch.argsort((~st["active"]).to(torch.int8), stable=True)
        st = _take_rows(st, order)
        T_k //= shrink
        segments.append({k: v[T_k:] for k, v in st.items()})
        st = {k: v[:T_k] for k, v in st.items()}
    st = run(st, 0)
    if segments:
        st = {k: torch.cat([st[k], *(s[k] for s in reversed(segments))])
              for k in st}
        st = _take_rows(st, torch.argsort(st["tile_id"]))
    take = lambda x: x.reshape(-1)[:b]
    if closest:
        t = take(st["t"])
        prim_slot = take(st["prim"])
        found = (prim_slot >= 0) & (t < t_max)
        prim = torch.where(found, _gather_rows(bvh.prim_index, prim_slot), -1)
        zero = torch.zeros_like(t)
        return Hit(t=torch.where(found, t, torch.full_like(t, BVH_FAR)),
                   u=torch.where(found, take(st["u"]), zero),
                   v=torch.where(found, take(st["v"]), zero),
                   prim=prim.to(torch.int32),
                   inst=torch.where(found, 0, -1).to(torch.int32))
    return take(st["occ"])


def intersect_closest_wave(bvh: BVHArrays, o, d, t_max=None, *,
                           tile: int = 128, stack_depth: int = 48,
                           leaf_size: int = 16, node_steps: int = 8,
                           leaf_cap: int = 4, dense: str = "mt",
                           shrink: int = 8) -> Hit:
    """Wave packet traversal, closest hit. o, d: (B, 3). Returns a Hit with
    prim in the scene's triangle order and inst 0 (-1 on a miss)."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    traverse.check_rays(bvh, o, d, t_max, "wave")
    return _wave_engine(bvh, o, d, t_max, closest=True, tile=tile,
                        stack_depth=stack_depth, leaf_size=leaf_size,
                        node_steps=node_steps, leaf_cap=leaf_cap, dense=dense,
                        shrink=shrink)


def intersect_any_wave(bvh: BVHArrays, o, d, t_max, *,
                       tile: int = 128, stack_depth: int = 48,
                       leaf_size: int = 16, node_steps: int = 8,
                       leaf_cap: int = 4, dense: str = "mt",
                       shrink: int = 8) -> torch.Tensor:
    """Wave occlusion query (see intersect_closest_wave)."""
    traverse.check_rays(bvh, o, d, t_max, "wave")
    return _wave_engine(bvh, o, d, t_max, closest=False, tile=tile,
                        stack_depth=stack_depth, leaf_size=leaf_size,
                        node_steps=node_steps, leaf_cap=leaf_cap, dense=dense,
                        shrink=shrink)


def morton_order(o, d, scene_lo, scene_hi, dead=None, mode="octant_major"):
    """Coherence permutation: the stable argsort of ``morton_key`` (its
    ``dead`` lanes last, its ``mode``)."""
    return torch.sort(morton_key(o, d, scene_lo, scene_hi, dead=dead, mode=mode),
                      stable=True).indices


def _scene_bounds(bvh: BVHArrays):
    """Root AABB from node 0 (union of its two child boxes)."""
    root = bvh.nodes_box[0]
    lo = torch.minimum(root[0:3], root[6:9])
    hi = torch.maximum(root[3:6], root[9:12])
    return lo, hi


def sorted_closest(fn, bvh: BVHArrays, o, d, t_max=None, **kw) -> Hit:
    """Run a closest-hit traversal on octant+Morton-sorted rays, unsorting
    the hits. Sorting restores the packet coherence the tile frusta depend
    on for bounce/shadow wavefronts: a tile of same-octant rays has
    sign-definite reciprocal-direction intervals, so node culling stays
    effective for incoherent ray sets."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    lo, hi = _scene_bounds(bvh)
    perm = morton_order(o, d, lo, hi)
    hit = fn(bvh, o[perm], d[perm], t_max[perm], **kw)
    return Hit(*(_unsort(perm, x) for x in hit))


def sorted_any(fn, bvh: BVHArrays, o, d, t_max, **kw) -> torch.Tensor:
    """Occlusion variant of sorted_closest."""
    lo, hi = _scene_bounds(bvh)
    perm = morton_order(o, d, lo, hi)
    return _unsort(perm, fn(bvh, o[perm], d[perm], t_max[perm], **kw))
