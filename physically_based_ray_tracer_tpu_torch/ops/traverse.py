"""The lane engine (``traversal="lane"``) and hit refinement; counterpart of ``physically_based_ray_tracer_tpu/ops/traverse.py``.

The whole ray batch steps the classic 2-wide BVH (``bvh/types.py``) in
lockstep: every lane holds its own stack and stack pointer, and one step is
either one node (both child boxes, nearer child first, the farther pushed)
or one leaf (``leaf_size`` Möller-Trumbore tests, the first smallest t
kept; the tests are the packet engine's ``mt_dense``, so the two engines
give bit-equal t). Lanes that finish go inactive; the loop ends when no
lane is active. The any-hit variant retires a lane at its first accepted
hit.

Written in torch, like the JAX package's XLA loop (no kernel is owed: the
JAX engine is not a Pallas kernel). Two things differ from a literal copy:

* **The loop runs in blocks** (``run_steps``, shared with the packet
  engine). The loop test is read every ``CHECK_EVERY`` steps, not every
  step (a host sync each time on the card); a read that finds at most
  ``COMPACT_BELOW`` of the working lanes active drops the finished ones;
  on the card a block is replayed as a CUDA graph once ``GRAPH_AFTER``
  blocks have run on the same lanes. A finished lane is a fixed point of
  the step (no push, no pop, no take: its leaf slots are masked to 1e30 and
  the take is a strict ``<``) and lanes are independent, so none of this
  changes a result; ``tests/test_torch_classic.py`` pins the blocks against
  the literal loop bit for bit (and the CUDA graphs against the op-by-op
  steps on the card).
* **Stack overflow is emulated, not faulted.** In JAX a push onto a full
  stack is lost while the stack pointer still grows, and the later pop reads
  past the end, where ``take_along_axis`` returns its fill value INT32_MIN:
  a negative child code, so it decodes as a leaf (first 16777215, count
  127) whose slots the clipping gather clamps to the last triangle row.
  ``torch.gather`` would raise on the CPU and assert on the card, so the
  pop reads INT32_MIN itself where the pointer is past the end, and every
  gather clamps. The answers equal the JAX engine's at any depth (not brute
  force's once the stack overflows). Overflow pushes are counted on the
  device (``overflow_pushes``).

``STEPS`` counts the steps run per mode (host-side, the extra ones
included). ``packet`` and ``wave`` engines: ``ops/traverse_packet.py``.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.bvh.types import (LEAF_COUNT_MASK, BVHArrays,
                                                             decode_leaf)
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit, safe_rcp
from physically_based_ray_tracer_tpu_torch.ops.leaf_mt import _gather_rows, mt_dense
from physically_based_ray_tracer_tpu_torch.utils.math import cross

DONE = 0x7FFFFFFF
# jnp.take_along_axis's fill value for an int32 read past the end
INT32_MIN = -2**31
# steps between two reads of the loop test (a host sync on the card), and
# the active share of the working rows at or below which a read compacts
# them (run_steps)
CHECK_EVERY = 8
COMPACT_BELOW = 0.5
# on the card, a block of CHECK_EVERY steps runs as one CUDA graph once
# GRAPH_AFTER blocks have run op by op on the same working rows (run_steps)
CUDA_GRAPHS = True
GRAPH_AFTER = 2
STEPS = {"closest": 0, "any": 0}
# per device: pushes onto a full stack by the lane and packet engines (int64)
_OVERFLOW: dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    for k in STEPS:
        STEPS[k] = 0


def overflow_pushes(device) -> int:
    """Pushes onto a full stack on ``device`` so far, by the lane and packet
    engines (synchronises)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _OVERFLOW.get(device)
    return 0 if c is None else int(c.item())


def _overflow_counter(dev) -> torch.Tensor:
    c = _OVERFLOW.get(dev)
    if c is None:
        c = _OVERFLOW[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return c


def check_rays(bvh: BVHArrays, o, d, t_max, engine: str) -> None:
    """The classic-BVH engines' input checks: a BVH, and float32 rays of
    matching shapes on its device."""
    if bvh is None:
        raise ValueError(f"the {engine} engine needs the scene's classic BVH "
                         "(SceneData.bvh; build with legacy_bvh=True)")
    B = o.shape[0]
    for name, x, shape in (("o", o, (B, 3)), ("d", d, (B, 3)), ("t_max", t_max, (B,))):
        if x.device != bvh.tris.device:
            raise ValueError(f"{name} is on {x.device}, the BVH on {bvh.tris.device}")
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")


def run_steps(body, s: dict, keep: tuple, mode: str, steps: dict) -> None:
    """``while any(s["active"]): body(rows)``, the test read every
    CHECK_EVERY steps. ``s`` holds one row per lane (or tile) in each
    tensor; ``body`` updates the rows it is given (a dict of the same
    keys). Where a read finds at most COMPACT_BELOW of the working rows
    active, the working rows' ``keep`` keys are written back to ``s`` and the
    steps go on over the active rows alone: rows are independent and a
    finished row is a fixed point of the step, so no result changes. On the
    card, once GRAPH_AFTER blocks of CHECK_EVERY steps have run op by op on
    the same working rows, the block is captured as one CUDA graph
    (``_capture``) and replayed until the next compaction, so that the host
    issues one launch a block instead of ~100 a step. ``s`` holds every
    row's final state on return."""
    work, idx, graph, blocks = s, None, None, 0
    while True:
        active = work["active"]
        n = int(active.sum())              # the loop test: one host sync
        if n == 0:
            break
        if n <= COMPACT_BELOW * active.shape[0]:
            live = torch.nonzero(active).flatten()
            if idx is not None or graph is not None:
                for k in keep:
                    if idx is None:
                        s[k].copy_(work[k])
                    else:
                        s[k][idx] = work[k]
            work = {k: v[live] for k, v in work.items()}
            idx = live if idx is None else idx[live]
            graph, blocks = None, 0
        if (graph is None and CUDA_GRAPHS and blocks >= GRAPH_AFTER
                and active.device.type == "cuda"):
            graph, work = _capture(body, work)
        if graph is not None:
            graph.replay()
        else:
            for _ in range(CHECK_EVERY):
                body(work)
        blocks += 1
        steps[mode] += CHECK_EVERY
    if idx is not None or graph is not None:
        for k in keep:
            if idx is None:
                s[k].copy_(work[k])
            else:
                s[k][idx] = work[k]


def _capture(body, work: dict):
    """CHECK_EVERY steps of ``body`` captured as one CUDA graph over copies
    of ``work``'s tensors: (graph, static). Each replay runs the steps on
    ``static`` in place (its tensors are the graph's inputs and outputs);
    nothing runs at capture."""
    static = {k: v.clone() for k, v in work.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = dict(static)
        for _ in range(CHECK_EVERY):
            body(cur)
        for k, v in cur.items():
            if v is not static[k]:
                static[k].copy_(v)
    return graph, static


def empty_slot(c):
    """Child codes of empty leaf slots (count 0), which never hit."""
    return (c < 0) & (((-(c + 1)) & LEAF_COUNT_MASK) == 0)


def stack_step(stack, sp, nxt, push, pushed, active):
    """The engines' shared stack update, as the JAX loop does it: push
    ``pushed`` where ``push`` (lost when the stack is full, the pointer
    still grows), then pop where ``nxt`` is DONE (INT32_MIN past the end).
    Updates ``stack`` in place; returns (nxt, sp, exhausted): the lanes that
    needed a pop from an empty stack."""
    S = stack.shape[1]
    at = sp.clamp(max=S - 1).long()[:, None]
    keep = push & (sp < S)
    stack.scatter_(1, at, torch.where(keep, pushed, stack.gather(1, at)[:, 0])[:, None])
    _overflow_counter(sp.device).add_((push & (sp >= S)).sum())
    sp = sp + push.to(sp.dtype)
    need_pop = (nxt == DONE) & active
    can_pop = need_pop & (sp > 0)
    sp_pop = (sp - 1).clamp(min=0)
    top = stack.gather(1, sp_pop.clamp(max=S - 1).long()[:, None])[:, 0]
    top = torch.where(sp_pop < S, top, torch.full_like(top, INT32_MIN))
    nxt = torch.where(can_pop, top, nxt)
    sp = torch.where(can_pop, sp_pop, sp)
    return nxt, sp, need_pop & ~can_pop


def _slab(o, rd, box, t_max):
    """Both child boxes of a node row (B, 12) against the rays: (entry
    distance or BVH_FAR, hit), each (B, 2)."""
    box = box.view(-1, 2, 6)
    t1 = (box[:, :, 0:3] - o[:, None, :]) * rd[:, None, :]
    t2 = (box[:, :, 3:6] - o[:, None, :]) * rd[:, None, :]
    tnear = torch.amax(torch.minimum(t1, t2), dim=-1)
    tfar = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tfar >= tnear) & (tnear < t_max[:, None]) & (tfar > 0.0)
    return torch.where(hit, tnear.clamp(min=0.0), torch.full_like(tnear, BVH_FAR)), hit


def leaf_slots(bvh, cur, is_leaf, leaf_size):
    """(first, count, slots (B, K), rows (B, K, 9)) of the lanes' leaves;
    a lane not at a leaf decodes -1 (count 0) and reads row 0."""
    first, count = decode_leaf(torch.where(is_leaf, cur, torch.full_like(cur, -1)))
    k = torch.arange(leaf_size, dtype=torch.int32, device=cur.device)
    slots = first[:, None] + k[None, :]
    rows = _gather_rows(bvh.tris, torch.where(is_leaf[:, None], slots, 0))
    return first, count, slots, rows


def _leaf_mt(o, d, rows, t_clip):
    """Each lane against its leaf's K rows: (t, u, v, hit), each (B, K).
    The packet engine's explicit-component Möller-Trumbore (``mt_dense``,
    every lane a tile of one ray), so that both engines round t alike; the
    JAX lane engine's ``intersect_tri`` computes the same expressions."""
    return tuple(x[:, 0] for x in mt_dense(o[:, None, :], d[:, None, :], rows,
                                           t_clip[:, None]))


def stack_state(n, stack_depth, dev):
    """(cur, sp, stack) of ``n`` lanes or tiles at the root, stacks empty."""
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.zeros((n,), **i32), torch.zeros((n,), **i32),
            torch.full((n, stack_depth), DONE, **i32))


def _lane_state(o, d, stack_depth, dev):
    B = o.shape[0]
    cur, sp, stack = stack_state(B, stack_depth, dev)
    return dict(o=o, d=d, rd=safe_rcp(d), cur=cur, sp=sp, stack=stack,
                active=torch.ones((B,), dtype=torch.bool, device=dev))


def _node_step(bvh, s, t_clip):
    """The lanes' node step: (is_leaf, children (B, 2), entry (B, 2), hit
    (B, 2)) at their nodes (node 0 for a leaf or a finished lane), empty
    leaf slots rejected."""
    cur = s["cur"]
    is_leaf = cur < 0
    node_idx = torch.where(is_leaf | ~s["active"], 0, cur)
    box = _gather_rows(bvh.nodes_box, node_idx)              # (B, 12)
    child = _gather_rows(bvh.nodes_child, node_idx)          # (B, 2)
    dist, hit = _slab(s["o"], s["rd"], box, t_clip)
    return is_leaf, child, dist, hit & ~empty_slot(child)


def intersect_closest(bvh: BVHArrays, o, d, t_max=None, *,
                      stack_depth: int = 48, leaf_size: int = 4) -> Hit:
    """Closest-hit traversal for a ray batch. o, d: (B, 3); t_max: optional
    (B,) initial clip distance. Returns a Hit with prim in the scene's
    triangle order (through ``prim_index``). A miss keeps t at ``t_max``
    (BVH_FAR without one), u = v = 0, prim = inst = -1."""
    B = o.shape[0]
    dev = o.device
    t = torch.full((B,), BVH_FAR, dtype=o.dtype, device=dev) if t_max is None \
        else t_max.clone()
    check_rays(bvh, o, d, t, "lane")
    st = _lane_state(o, d, stack_depth, dev)
    st.update(t=t, u=torch.zeros((B,), dtype=o.dtype, device=dev),
              v=torch.zeros((B,), dtype=o.dtype, device=dev),
              prim=torch.full((B,), -1, dtype=torch.int32, device=dev))
    kk = torch.arange(leaf_size, dtype=torch.int32, device=dev)
    big = torch.tensor(1e30, dtype=o.dtype, device=dev)

    def body(s):
        cur, t, active = s["cur"], s["t"], s["active"]
        is_leaf, child, dist, hit = _node_step(bvh, s, t)
        swap = dist[:, 1] < dist[:, 0]
        c0, c1 = child[:, 0], child[:, 1]
        near = torch.where(swap, c1, c0)
        far = torch.where(swap, c0, c1)
        near_hit = torch.where(swap, hit[:, 1], hit[:, 0])
        far_hit = torch.where(swap, hit[:, 0], hit[:, 1])
        internal_next = torch.where(near_hit, near,
                                    torch.where(far_hit, far, torch.full_like(far, DONE)))
        push = near_hit & far_hit & active & ~is_leaf
        # leaf step: one (B, K) gather and K Möller-Trumbore tests
        first, count, _, rows = leaf_slots(bvh, cur, is_leaf, leaf_size)
        kt, ku, kv, khit = _leaf_mt(s["o"], s["d"], rows, t)
        kvalid = khit & (kk[None, :] < count[:, None]) & (is_leaf & active)[:, None]
        kt = torch.where(kvalid, kt, big)
        kbest = torch.argmin(kt, dim=1, keepdim=True)              # the first minimum
        kt_b = torch.gather(kt, 1, kbest)[:, 0]
        take = kt_b < t
        s["t"] = torch.where(take, kt_b, t)
        s["u"] = torch.where(take, torch.gather(ku, 1, kbest)[:, 0], s["u"])
        s["v"] = torch.where(take, torch.gather(kv, 1, kbest)[:, 0], s["v"])
        s["prim"] = torch.where(take, first + kbest[:, 0].to(torch.int32), s["prim"])
        # merge + stack
        nxt = torch.where(is_leaf, torch.full_like(cur, DONE), internal_next)
        nxt, s["sp"], exhausted = stack_step(s["stack"], s["sp"], nxt, push, far, active)
        s["active"] = active & ~exhausted
        s["cur"] = torch.where(s["active"], nxt, torch.full_like(nxt, DONE))

    run_steps(body, st, ("t", "u", "v", "prim"), "closest", STEPS)
    found = st["prim"] >= 0
    prim = torch.where(found, _gather_rows(bvh.prim_index, st["prim"].clamp(min=0)), -1)
    return Hit(t=st["t"], u=st["u"], v=st["v"], prim=prim.to(torch.int32),
               inst=torch.where(found, 0, -1).to(torch.int32))


def intersect_any(bvh: BVHArrays, o, d, t_max, *,
                  stack_depth: int = 48, leaf_size: int = 4) -> torch.Tensor:
    """Occlusion query: True where a hit exists with t in (0, t_max); a lane
    retires at its first accepted hit."""
    check_rays(bvh, o, d, t_max, "lane")
    dev = o.device
    st = _lane_state(o, d, stack_depth, dev)
    st.update(t_max=t_max, occ=torch.zeros((o.shape[0],), dtype=torch.bool, device=dev))
    kk = torch.arange(leaf_size, dtype=torch.int32, device=dev)

    def body(s):
        cur, active, t_max = s["cur"], s["active"], s["t_max"]
        is_leaf, child, _, hit = _node_step(bvh, s, t_max)
        h0, h1 = hit[:, 0], hit[:, 1]
        c0, c1 = child[:, 0], child[:, 1]
        internal_next = torch.where(h0, c0, torch.where(h1, c1, torch.full_like(c1, DONE)))
        push = h0 & h1 & active & ~is_leaf

        _, count, _, rows = leaf_slots(bvh, cur, is_leaf, leaf_size)
        khit = _leaf_mt(s["o"], s["d"], rows, t_max)[3]
        kvalid = khit & (kk[None, :] < count[:, None]) & (is_leaf & active)[:, None]
        s["occ"] = s["occ"] | torch.any(kvalid, dim=1)

        nxt = torch.where(is_leaf, torch.full_like(cur, DONE), internal_next)
        nxt, s["sp"], exhausted = stack_step(s["stack"], s["sp"], nxt, push, c1, active)
        s["active"] = active & ~exhausted & ~s["occ"]
        s["cur"] = torch.where(s["active"], nxt, torch.full_like(nxt, DONE))

    run_steps(body, st, ("occ",), "any", STEPS)
    return st["occ"]


def refine_hit(o, d, v0, e1, e2, mask=None):
    """(t, u, v) of a known hit triangle, recomputed from the original-order
    world triangle. ``mask`` marks lanes with a real hit; the others get
    sanitised inputs before the division and zero outputs."""
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    if mask is not None:
        det = torch.where(mask, det, torch.ones_like(det))
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    if mask is not None:
        zero = torch.zeros_like(t)
        t = torch.where(mask, t, zero)
        u = torch.where(mask, u, zero)
        v = torch.where(mask, v, zero)
    return t, u, v
