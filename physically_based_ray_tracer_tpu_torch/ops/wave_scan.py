"""The wave engine's node scan; counterpart of ``_wave_node_scan`` in ``physically_based_ray_tracer_tpu/ops/traverse_packet.py``.

One wave of the wave engine first runs ``node_steps`` node-only traversal
steps per ray tile, each tile with one cursor and one stack over the
classic BVH, buffering up to ``leaf_cap`` leaf codes for the dense leaf
phase (``ops/leaf_mt.py``). A step tests the tile's conservative frustum
(origin box and reciprocal-direction interval) against both children's
boxes, descends into the nearer hit child, pushes the farther one, appends
a leaf it stands on (or stalls on it while the buffer is full) and pops
when it has nowhere to go.

In the JAX package this is XLA code, not a TPU kernel. The port runs it as
one kernel launch per wave (``csrc/wave_scan.cu``, one thread per tile, all
steps in registers), because a scan of torch operators costs about 45
launches a step, minutes per frame. ``node_scan`` dispatches on the state's
device: CUDA launches the kernel (counted in ``LAUNCHES``) or raises; the
CPU runs ``plain_node_scan``, the JAX scan in torch (``PLAIN_CALLS``). Both
update the tile state in place. A push past ``stack_depth`` (which the JAX
package drops silently) is counted as a truncated push on both devices
(``truncated_pushes``), and the pop then reads the clamped top slot.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays, decode_leaf
from physically_based_ray_tracer_tpu_torch.ops import trace

DONE = 0x7FFFFFFF
BIG = 1e30
LAUNCHES = {"scan": 0}
PLAIN_CALLS = {"scan": 0}
# per-device int32 count of pushes past the stack depth
_TRUNCATED: dict[torch.device, torch.Tensor] = {}
# operations per tile-step on a node, from csrc/wave_scan.cu: two interval
# slab tests of 85 (per axis 4 subtractions, 2 interval products of 4
# multiplies and 6 min/max, 2 min/max; then 4 min/max and 3 compares) and
# the near/far compare
UNIT_OPS = {"tile_steps": {"f32": 171}}
# bytes of the tile state: per active tile, the bounds and pruning distance
# (o_lo, o_hi, rd_lo, rd_hi, t_tile) and cur, sp read, cur, sp, active
# written; a node's table row (nodes_box 12 f32, nodes_child 2 i32)
TILE_IN_BYTES = 60
TILE_OUT_BYTES = 9
NODE_BYTES = 56
# tile state the scan reads and writes, in the kernel's argument order
STATE_KEYS = ("cur", "sp", "stack", "active")


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def truncated_pushes(device) -> int:
    """Pushes past the stack depth on ``device`` so far (synchronises)."""
    return trace.truncated_rays(device, _TRUNCATED)


def _interval_slab(box, o_lo, o_hi, rd_lo, rd_hi, t_max_tile):
    """Conservative tile-vs-AABB test.

    box: (T, 6) child AABB; o_lo/o_hi: (T, 3) tile origin bounds;
    rd_lo/rd_hi: (T, 3) reciprocal-direction interval (already widened to
    +/-BIG when the tile's direction interval spans zero).
    Returns (entry_lower_bound (T,), may_hit (T,)).
    """
    bmin = box[:, 0:3]
    bmax = box[:, 3:6]

    def iprod(a_lo, a_hi, b_lo, b_hi):
        p1 = a_lo * b_lo
        p2 = a_lo * b_hi
        p3 = a_hi * b_lo
        p4 = a_hi * b_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    # t intervals for both slab planes per axis
    a1_lo = bmin - o_hi
    a1_hi = bmin - o_lo
    a2_lo = bmax - o_hi
    a2_hi = bmax - o_lo
    t1_lo, t1_hi = iprod(a1_lo, a1_hi, rd_lo, rd_hi)
    t2_lo, t2_hi = iprod(a2_lo, a2_hi, rd_lo, rd_hi)
    # per-ray tnear_axis = min(t1,t2) >= min of lower bounds
    lo_axis = torch.minimum(t1_lo, t2_lo)       # (T, 3)
    hi_axis = torch.maximum(t1_hi, t2_hi)
    enter_lb = torch.amax(lo_axis, dim=-1)      # lower bound of per-ray tnear
    exit_ub = torch.amin(hi_axis, dim=-1)       # upper bound of per-ray tfar
    may_hit = (enter_lb <= exit_ub) & (exit_ub > 0.0) & (enter_lb < t_max_tile)
    return enter_lb, may_hit


def _counter(dev) -> torch.Tensor:
    trunc = _TRUNCATED.get(dev)
    if trunc is None:
        trunc = _TRUNCATED[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return trunc


def plain_node_scan(bvh: BVHArrays, st: dict, node_steps: int, leaf_cap: int):
    """The plain version: ``node_steps`` steps of the JAX scan in torch.
    Returns new (cur, sp, stack, nleaf, leafbuf, active); ``st`` is not
    touched."""
    PLAIN_CALLS["scan"] += 1
    return _scan(bvh, st, node_steps, leaf_cap)


def count_work(bvh: BVHArrays, st: dict, node_steps: int, leaf_cap: int) -> dict:
    """The work one launch needs on this tile state, for its bound (runs
    the plain scan on a copy, uncounted; synchronises): the tile-steps on a
    node (an active tile standing on an internal node; a step on a leaf
    tests no box) with the operations ``UNIT_OPS`` gives them, and the bytes
    it must move: every tile's active flag read and its nleaf and leaf
    buffer written; each active tile's state (``TILE_IN_BYTES``,
    ``TILE_OUT_BYTES``); 4 for each push and pop; each distinct node
    visited once (``NODE_BYTES``)."""
    work = {"tile_steps": 0, "pushes": 0, "pops": 0, "nodes": []}
    _scan(bvh, st, node_steps, leaf_cap, work)
    T = st["cur"].shape[0]
    active = int(st["active"].sum())
    nodes = int(torch.unique(torch.cat(work.pop("nodes"))).numel())
    work.update(active_tiles=active, distinct_nodes=nodes)
    work["bytes"] = (T * (1 + 4 + 4 * leaf_cap) + active * (TILE_IN_BYTES + TILE_OUT_BYTES)
                     + 4 * (work["pushes"] + work["pops"]) + NODE_BYTES * nodes)
    work["ops"] = {kind: work["tile_steps"] * n
                   for kind, n in UNIT_OPS["tile_steps"].items()}
    return work


def _scan(bvh: BVHArrays, st: dict, node_steps: int, leaf_cap: int, work=None):
    """The scan of ``plain_node_scan``. Where ``work`` is given, it adds the
    tile-steps on a node, the nodes they visit, the pushes kept and the pops
    there, and leaves the truncated-push count alone."""
    cur, sp, stack, active = (st[k] for k in STATE_KEYS)
    o_lo, o_hi, rd_lo, rd_hi, t_tile = (st[k] for k in ("o_lo", "o_hi", "rd_lo",
                                                          "rd_hi", "t_tile"))
    T, S = stack.shape
    dev = cur.device
    trunc = _counter(dev) if work is None else torch.zeros((1,), dtype=torch.int32,
                                                            device=dev)
    nleaf = torch.zeros((T,), dtype=torch.int32, device=dev)
    leafbuf = torch.full((T, leaf_cap), -1, dtype=torch.int32, device=dev)
    lidx = torch.arange(leaf_cap, dtype=torch.int32, device=dev)[None, :]
    sidx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    done = torch.full_like(cur, DONE)
    for _ in range(node_steps):
        is_leaf = cur < 0
        full = nleaf >= leaf_cap
        append = is_leaf & active & ~full
        leafbuf = torch.where((lidx == nleaf[:, None]) & append[:, None],
                              cur[:, None], leafbuf)
        nleaf = nleaf + append.to(torch.int32)

        node_idx = torch.where(is_leaf | ~active, 0, cur)
        box = bvh.nodes_box[node_idx.clamp(0, bvh.n_nodes - 1).long()]
        child = bvh.nodes_child[node_idx.clamp(0, bvh.n_nodes - 1).long()]
        d0, h0 = _interval_slab(box[:, 0:6], o_lo, o_hi, rd_lo, rd_hi, t_tile)
        d1, h1 = _interval_slab(box[:, 6:12], o_lo, o_hi, rd_lo, rd_hi, t_tile)
        c0, c1 = child[:, 0], child[:, 1]
        e0 = (c0 < 0) & (decode_leaf(c0)[1] == 0)
        e1 = (c1 < 0) & (decode_leaf(c1)[1] == 0)
        h0 = h0 & ~e0
        h1 = h1 & ~e1
        swap = d1 < d0
        near = torch.where(swap, c1, c0)
        far = torch.where(swap, c0, c1)
        near_hit = torch.where(swap, h1, h0)
        far_hit = torch.where(swap, h0, h1)
        both = near_hit & far_hit
        internal_next = torch.where(near_hit, near, torch.where(far_hit, far, done))
        push = both & active & ~is_leaf

        over = push & (sp >= S)
        trunc += over.sum().to(torch.int32)
        stack = torch.where((sidx == sp[:, None]) & push[:, None], far[:, None], stack)
        sp = sp + push.to(torch.int32)

        nxt = torch.where(is_leaf, torch.where(full, cur, done), internal_next)
        need_pop = (nxt == DONE) & active
        can_pop = need_pop & (sp > 0)
        sp_pop = torch.clamp(sp - 1, min=0)
        top = torch.gather(stack, 1, sp_pop.clamp(max=S - 1)[:, None].long())[:, 0]
        nxt = torch.where(can_pop, top, nxt)
        sp = torch.where(can_pop, sp_pop, sp)
        if work is not None:
            on_node = active & ~is_leaf
            work["tile_steps"] += int(on_node.sum())
            work["nodes"].append(cur[on_node])
            work["pushes"] += int((push & ~over).sum())
            work["pops"] += int(can_pop.sum())
        active = active & ~(need_pop & ~can_pop)
        cur = torch.where(active, nxt, done)
    return cur, sp, stack, nleaf, leafbuf, active


def _check(bvh: BVHArrays, st: dict, leaf_cap: int):
    cur = st["cur"]
    T = cur.shape[0]
    dev = cur.device
    want = [(k, st[k], (T, 3), torch.float32) for k in ("o_lo", "o_hi", "rd_lo", "rd_hi")]
    want += [("t_tile", st["t_tile"], (T,), torch.float32),
             ("cur", cur, (T,), torch.int32), ("sp", st["sp"], (T,), torch.int32),
             ("stack", st["stack"], (T, st["stack"].shape[-1]), torch.int32),
             ("active", st["active"], (T,), torch.bool),
             ("nodes_box", bvh.nodes_box, (bvh.n_nodes, 12), torch.float32),
             ("nodes_child", bvh.nodes_child, (bvh.n_nodes, 2), torch.int32)]
    for name, x, shape, dtype in want:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the tile state on {dev}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)}, want {dtype} {shape}")
    if leaf_cap < 1:
        raise ValueError(f"leaf_cap {leaf_cap} < 1")


def _launch(bvh: BVHArrays, st: dict, node_steps: int, leaf_cap: int):
    from physically_based_ray_tracer_tpu_torch.ops import _build

    ins = [bvh.nodes_box, bvh.nodes_child, *(st[k] for k in ("o_lo", "o_hi", "rd_lo",
                                                            "rd_hi", "t_tile"))]
    state = [st[k] for k in STATE_KEYS]
    if not all(x.is_contiguous() for x in ins + state):
        raise ValueError("wave_scan: every tensor must be contiguous")
    T, S = st["stack"].shape
    dev = st["cur"].device
    nleaf = torch.empty((T,), dtype=torch.int32, device=dev)
    leafbuf = torch.empty((T, leaf_cap), dtype=torch.int32, device=dev)
    lib = _build.load("wave_scan")
    err = lib.pbrt_wave_scan(*(x.data_ptr() for x in ins), bvh.n_nodes,
                             *(x.data_ptr() for x in state), nleaf.data_ptr(),
                             leafbuf.data_ptr(), T, S, leaf_cap, node_steps,
                             _counter(dev).data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("wave_scan launch failed: "
                           + lib.pbrt_wave_scan_error_string(err).decode())
    LAUNCHES["scan"] += 1
    return nleaf, leafbuf


def node_scan(bvh: BVHArrays, st: dict, node_steps: int, leaf_cap: int):
    """Run ``node_steps`` node-only steps of every tile, buffering leaf codes.

    ``st`` holds the tile state (T tiles): ``cur``, ``sp`` (T,) i32,
    ``stack`` (T, S) i32, ``active`` (T,) bool, updated in place, and the
    read-only ``o_lo``, ``o_hi``, ``rd_lo``, ``rd_hi`` (T, 3) f32 and
    ``t_tile`` (T,) f32. Returns (cur, sp, stack, nleaf (T,) i32, leafbuf
    (T, leaf_cap) i32 leaf codes, -1 past nleaf, active)."""
    _check(bvh, st, leaf_cap)
    dev = st["cur"].device
    if dev.type == "cuda":
        nleaf, leafbuf = _launch(bvh, st, node_steps, leaf_cap)
    elif dev.type == "cpu":
        *new, nleaf, leafbuf, active = plain_node_scan(bvh, st, node_steps, leaf_cap)
        for k, x in zip(STATE_KEYS, (*new, active)):
            st[k].copy_(x)
    else:
        raise ValueError(f"no node scan for device {dev}")
    return st["cur"], st["sp"], st["stack"], nleaf, leafbuf, st["active"]
