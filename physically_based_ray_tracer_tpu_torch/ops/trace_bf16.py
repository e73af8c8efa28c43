"""bf16-sweep dense-BVH traversal (the bf16 engine, ``leaf_precision="bf16"``);
counterpart of ``physically_based_ray_tracer_tpu/ops/pallas_bf16.py``.

The node and TLAS phase is the exact f32 one of ``ops/trace.py``; only the
leaf visit differs. A visited leaf group is swept in bf16 in leaf-local
coordinates: the ray is re-originated at the group box entry in f32, cast to
bf16, and tested against the pre-rolled 2-band table ``groups_bf``
(``bvh/dense.py``) with the reference's arithmetic accept masks
(``_bf16_mt``): a 0.02-barycentric apron with a 5% t penalty, |det| and t
ramps, all in bf16. Closest mode returns the bf16 best t, a winner key
``gk = ((group*8 + log2 c)*64 + k)*2 + band`` and the instance; ``_decode_*``
turn the key back into a prim. Occlusion mode returns certain / uncertain
masks; ``_resolve_uncertain`` settles the uncertain lanes with the exact f32
traversal (``ops/trace.py``, kernel B1).

The absolute accept margins (``y*1e4``, ``|det|*1e8 - 0.01``, ``t*1e4``)
assume a scene near unit scale, as in the reference, which has no guard for
other scales either; the port copies them for parity.

The wrappers dispatch on the rays' device, as ``ops/trace.py`` does:
  * CUDA tensors launch the hand-written kernel ``csrc/traverse_bf16.cu``
    (built at first use by ``ops/_build.py``) or raise;
  * CPU tensors run ``plain_traverse_bf16``, a brute force over the same
    tables with the kernel's bf16 arithmetic (each bf16 operation computed
    in f32 and rounded to bf16, as both frameworks do on the CPU).
``LAUNCHES`` / ``PLAIN_CALLS`` count the two; both count in the program's
live-lane counter (``utils/profiling.count_lanes``) while a span is open.

The kernel gives ray ``i`` of a launch the sweep lane ``i mod 128``, the
lane the TPU tile gives it, so its winner keys decode exactly as the
reference's do. Decoding therefore runs in the order the kernel saw: the
sorted wrappers decode in sorted order and scatter back. The reference's
``_gated_decode`` slices the decode only to skip dead TPU tiles; the fast
decode is gather-only and exact under slicing, so the port decodes at full
width.
"""

from __future__ import annotations

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import (ABSENT, BF_ROWS,
                                                             GROUP_ROWS,
                                                             INST_F, LEAF_W,
                                                             NODE_F, RESTORE_ID,
                                                             DenseBVH)
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops import trace
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit, safe_rcp
from physically_based_ray_tracer_tpu_torch.ops.take_rows import take_rows
from physically_based_ray_tracer_tpu_torch.utils.profiling import count_lanes

APRON = 0.02            # barycentric accept apron (see _bf16_mt)
GLO_SMEM_LIMIT = 8192   # the reference's group-count limit of the bf16 engine
REFINE_WIN = 1          # the reference's default refine window (winner only)
# relative t band within which the order groups are visited in (TPU tile,
# GPU thread, plain brute force) may pick another winner or verdict
NEAR_BAND = 2.0 ** -6

# operations per counted unit, by type, from kernel B2's arithmetic
# (csrc/traverse_bf16.cu), at the function's native bf16 count (the kernel's
# f32 emulation of each bf16 rounding is not work the function needs), by
# mode (closest: True): a node step is B1's (``trace.UNIT_OPS``); a band
# candidate is the bf16 Möller-Trumbore (66: cross products 18, det 5, |det|
# and reciprocal 3, inv 2, re-based origin 3, u/v/t 18, min_uv 4, the u/v,
# det and interiorness ramps 12, their product 1), the masked global t 2,
# then the closest accept 15 or the any accept 18; a leaf visit is the f32
# group box gate (26), the re-origin (9), the casts of ray and entry to bf16
# (7) and, in closest mode, the band merge (5)
UNIT_OPS = {
    closest: {"node_steps": trace.UNIT_OPS["node_steps"],
              "tri_tests": {"bf16": 83 if closest else 86},
              "leaf_visits": {"f32": 47 if closest else 42}}
    for closest in (True, False)}

LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}
# per-device int32 count of rays that hit the step bound or the stack cap
_TRUNCATED: dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def truncated_rays(device) -> int:
    """Rays kernel B2 cut short on ``device`` so far (synchronises)."""
    return trace.truncated_rays(device, _TRUNCATED)


def has_bf16_tables(dbvh: DenseBVH) -> bool:
    return dbvh.groups_bf is not None and dbvh.glo is not None


def _check_tables(dbvh: DenseBVH, dev) -> None:
    if not has_bf16_tables(dbvh):
        raise ValueError("DenseBVH carries no bf16 tables (groups_bf, glo)")
    for name, dtype in (("groups_bf", torch.bfloat16), ("groups_bf2", torch.bfloat16),
                        ("glo", torch.float32)):
        x = getattr(dbvh, name)
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"dbvh.{name} must be contiguous {dtype} on {dev}")


def _lead(dbvh: DenseBVH, lib, o, d, t_max):
    """Checked launch arguments of B2: (table and ray pointers, B, max
    steps), the truncation counter and the stream."""
    o, d, t_max, trunc, stream = trace.launch_args(
        dbvh, o, d, t_max, lib.pbrt_trace_bf16_stack_cap(), _TRUNCATED)
    lead = (dbvh.nodes16.data_ptr(), dbvh.groups_bf2.data_ptr(), dbvh.glo.data_ptr(),
            dbvh.inst16.data_ptr(), int(dbvh.two_level), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), o.shape[0], trace.max_steps(dbvh))
    return lead, trunc, stream


def _launch(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """Launch kernel B2 on the current stream; returns raw outputs."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    lib = _build.load("traverse_bf16")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    B, dev = o.shape[0], o.device
    if closest:
        t = torch.empty((B,), dtype=torch.float32, device=dev)
        gk = torch.empty((B,), dtype=torch.int32, device=dev)
        inst = torch.empty_like(gk)
        err = lib.pbrt_trace_closest_bf16(*lead, t.data_ptr(), gk.data_ptr(),
                                          inst.data_ptr(), trunc.data_ptr(),
                                          stream)
        out = (t, gk, inst)
    else:
        cert = torch.empty((B,), dtype=torch.bool, device=dev)
        unc = torch.empty_like(cert)
        err = lib.pbrt_trace_any_bf16(*lead, cert.data_ptr(), unc.data_ptr(),
                                      trunc.data_ptr(), stream)
        out = (cert, unc)
    if err != 0:
        raise RuntimeError("traverse_bf16 launch failed: "
                           + lib.pbrt_trace_bf16_error_string(err).decode())
    LAUNCHES["closest" if closest else "any"] += 1
    return out


def count_work(dbvh: DenseBVH, o, d, t_max, closest: bool) -> dict:
    """Node steps, band candidates (``tri_tests``) and leaf visits of one B2
    launch on these CUDA rays, and their operations (see
    ``trace.run_counting``)."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    _check_rays(dbvh, o, d, t_max)
    lib = _build.load("traverse_bf16")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    t, _, _, gk, inst, cert = trace.raw_outputs(o.shape[0], o.device)
    return trace.run_counting(lib.pbrt_trace_count_bf16,
                              lib.pbrt_trace_bf16_error_string, (*lead, int(closest)),
                              (t, gk, inst, cert, torch.empty_like(cert)), trunc,
                              stream, UNIT_OPS[closest])


# the packed operations of B2's sweep, in the order pbrt_bf16x2_check counts
# their mismatches
PACKED_OPS = ("mul", "add", "sub", "min", "max", "abs")


def packed_op_mismatches(device) -> dict:
    """Kernel B2's exhaustive check on a CUDA ``device``: the sweep's packed
    bf16x2 helpers over all 2^32 pairs of bf16 operands (abs: every
    operand), each result against f32 arithmetic rounded to bf16 (all NaNs
    one class). Returns {operation: mismatches}; 0 everywhere is what lets
    the packed sweep equal the plain version bit for bit."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the bf16x2 check runs on a CUDA device, not {device}")
    lib = _build.load("traverse_bf16")
    counts = torch.zeros((len(PACKED_OPS),), dtype=torch.int64, device=device)
    err = lib.pbrt_bf16x2_check(counts.data_ptr(),
                                torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("bf16x2 check launch failed: "
                           + lib.pbrt_trace_bf16_error_string(err).decode())
    return dict(zip(PACKED_OPS, counts.tolist()))


# ---------------------------------------------------------------------------
# Plain version: brute force over the same tables, the kernel's arithmetic
# ---------------------------------------------------------------------------

def _bf(x: float, device) -> torch.Tensor:
    """A bf16 constant as the reference rounds it (f32, then nearest even)."""
    return torch.tensor(x, dtype=torch.float32, device=device).to(torch.bfloat16)


def _bf16_mt(o3, d3, comps, K):
    """2-band bf16 Möller-Trumbore, operation for operation as the reference
    (and the kernel) computes it; every operation rounds to bf16. Returns
    (tt, m, r_in, min_uv): local t, the u/v/det accept mask, the interiorness
    ramp of the apron penalty, and the smallest barycentric."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = comps
    one, zero = K["1"], K["0"]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    adet = torch.abs(det)
    r = one / torch.maximum(adet, K["1e-8"])
    inv = det * r * r
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    min_uv = torch.minimum(torch.minimum(uu, vv), one - uu - vv)
    y = min_uv + K["apron"]
    m = torch.maximum(torch.minimum(y * K["1e4"], one), zero)
    m_det = torch.maximum(torch.minimum(adet * K["1e8"] - K["0.01"], one), zero)
    r_in = torch.maximum(torch.minimum(min_uv * K["1/apron"] + one, one), zero)
    return tt, m * m_det, r_in, min_uv


def bf16_constants(device) -> dict:
    return {name: _bf(x, device) for name, x in (
        ("0", 0.0), ("1", 1.0), ("1e-8", 1e-8), ("1e4", 1e4), ("1e8", 1e8),
        ("0.01", 0.01), ("apron", APRON), ("1/apron", 1.0 / APRON),
        ("0.05", 0.05), ("1e30", 1e30))}


def _leaf_boxes(nodes: np.ndarray, root: int) -> dict[int, np.ndarray]:
    """group -> its leaf's box in the parent node, [lo.xyz, hi.xyz], for the
    triangle leaves under ``root`` (instance leaves are not followed)."""
    out, stack = {}, [root]
    while stack:
        n = stack.pop()
        for side in range(2):
            code = int(np.rint(nodes[n, 12 + side]))
            if code >= 0:
                stack.append(code)
            elif code != ABSENT and (-(code + 1)) % 2 == 0:
                out[(-(code + 1)) // 2 // 8] = nodes[n, 6 * side:6 * side + 6]
    return out


def _space_table(dbvh: DenseBVH, root: int, nodes: np.ndarray) -> dict:
    """The sweep candidates of the triangle leaves under ``root``, in group
    order: candidate j = (group, iteration k, band b) with its group slot,
    winner key and in-group rank, and the bf16 components every lane tests
    for it, ``comps[lane, i, j] = groups_bf[32g + 2i + b, (lane - k) mod 128]``;
    per group its ``glo`` box and its leaf-node box."""
    leaves = sorted(trace._leaves(nodes, root))
    boxes = _leaf_boxes(nodes, root)
    dev = dbvh.groups_bf.device
    slot, key, rank, rows, ks = [], [], [], [], []
    for gi, (g, c) in enumerate(leaves):
        log2c = c.bit_length() - 1
        for k in range(max(c // 2, 1)):
            for b in range(2):
                slot.append(gi)
                key.append(((g * 8 + log2c) * 64 + k) * 2 + b)
                rank.append(gi * 128 + 127 - (2 * k + b))
                rows.append([g * BF_ROWS + 2 * i + b for i in range(9)])
                ks.append(k)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)
    rows_t, ks_t = as_t(rows).reshape(-1, 9), as_t(ks)
    lanes = torch.arange(LEAF_W, device=dev)
    cols = torch.remainder(lanes[:, None] - ks_t[None, :], LEAF_W)   # (128, K)
    comps = dbvh.groups_bf[rows_t.T[None, :, :], cols[:, None, :]]    # (128, 9, K)
    gidx = as_t([g for g, _ in leaves])
    glo = dbvh.glo.reshape(-1, 8)[gidx] if leaves else \
        torch.zeros((0, 8), device=dev)
    node_box = torch.as_tensor(np.array([boxes[g] for g, _ in leaves], np.float32)
                               .reshape(-1, 6), device=dev)
    return dict(slot=as_t(slot), key=as_t(key), rank=as_t(rank), comps=comps,
                glo=glo, node_box=node_box, n_groups=len(leaves),
                groups=[g for g, _ in leaves])


REF_TILE = 1024         # rays per walk of the reference TPU kernel (one program)
_DONE = 0x7FFFFFFF
_BIG = 1e30


def _tile_walk(dbvh: DenseBVH, o, d, t_max, pair_t, pair_k, pair_col, tiles):
    """The winners of the reference TPU kernel's closest-hit walk for the
    rays of ``tiles`` (each tile = REF_TILE consecutive rays of the launch).

    The reference walks a tile's rays together, with one stack: at a node it
    descends first into the child whose smallest slab entry over the tile's
    lanes that hit it (clipped at each lane's running best t) is smaller,
    and at a leaf every lane takes the group's best candidate only if it is
    strictly smaller than the lane's running best. ``pair_t`` / ``pair_k``
    (B, P) are each lane's best candidate t and winner key per (space,
    group) pair from the brute force; ``pair_col`` (spaces, groups) maps a
    pair to its column (-1: none). Returns (t, gk, inst) for the tiles'
    rays, (len(tiles), REF_TILE) each."""
    dev = o.device
    B = o.shape[0]
    NT = tiles.shape[0]
    rows = tiles[:, None] * REF_TILE + torch.arange(REF_TILE, device=dev)[None, :]
    valid = rows < B
    rows = rows.clamp(max=B - 1)
    wo = [o[rows, a] for a in range(3)]
    wd = [d[rows, a] for a in range(3)]
    t_ref = torch.where(valid, t_max[rows], torch.zeros_like(t_max[rows]))
    gk = torch.full((NT, REF_TILE), -1, dtype=torch.int32, device=dev)
    iout = torch.full_like(gk, -1)
    ro, rdir = list(wo), list(wd)
    rr = [safe_rcp(c) for c in rdir]
    nodes = dbvh.nodes16.reshape(-1, NODE_F)
    inst16 = dbvh.inst16.reshape(-1, INST_F) if dbvh.two_level else None
    sent = -((RESTORE_ID * 2 + 1) + 1)
    cap = 2 * nodes.shape[0] + 16
    stack = torch.zeros((NT, cap), dtype=torch.int64, device=dev)
    sp = torch.zeros((NT,), dtype=torch.int64, device=dev)
    cur = torch.zeros((NT,), dtype=torch.int64, device=dev)
    inst = torch.full((NT,), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(NT, device=dev)

    def slab(lo, hi):
        t0 = [(lo[:, a, None] - ro[a]) * rr[a] for a in range(3)]
        t1 = [(hi[:, a, None] - ro[a]) * rr[a] for a in range(3)]
        tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                         torch.maximum(t0[1], t1[1])),
                           torch.maximum(t0[2], t1[2]))
        h = (tn <= tf) & (tf > 0.0) & (tn < t_ref) & (t_ref > 0.0)
        return h, tn

    while bool((cur != _DONE).any()):
        live = cur != _DONE
        is_leaf = live & (cur < 0)
        v = torch.where(is_leaf, -(cur + 1), torch.zeros_like(cur))
        if dbvh.two_level:
            is_inst = is_leaf & (v % 2 == 1)
            iid = v // 2
            is_restore = is_inst & (iid == RESTORE_ID)
            enter = is_inst & ~is_restore
        else:
            is_inst = is_restore = enter = torch.zeros_like(is_leaf)
        is_tri = is_leaf & ~is_inst
        is_node = live & ~is_leaf

        nd = nodes[torch.where(is_node, cur, torch.zeros_like(cur))]
        c0, c1 = nd[:, 12].long(), nd[:, 13].long()
        h0, tn0 = slab(nd[:, 0:3], nd[:, 3:6])
        h1, tn1 = slab(nd[:, 6:9], nd[:, 9:12])
        any0 = h0.any(dim=1) & (c0 != ABSENT)
        any1 = h1.any(dim=1) & (c1 != ABSENT)
        m0 = torch.where(h0, tn0, torch.full_like(tn0, _BIG)).min(dim=1).values
        m1 = torch.where(h1, tn1, torch.full_like(tn1, _BIG)).min(dim=1).values
        swap = m1 < m0
        near_c = torch.where(swap, c1, c0)
        far_c = torch.where(swap, c0, c1)
        near_ok = torch.where(swap, any1, any0)
        far_ok = torch.where(swap, any0, any1)
        push = is_node & near_ok & far_ok
        stack[ar, sp.clamp(max=cap - 1)] = torch.where(push, far_c,
                                                       stack[ar, sp.clamp(max=cap - 1)])
        sp = sp + push.long()
        nxt = torch.where(near_ok, near_c,
                          torch.where(far_ok, far_c, torch.full_like(cur, _DONE)))
        nxt = torch.where(is_node, nxt, torch.full_like(cur, _DONE))

        if bool(is_tri.any()):
            g = (v // 2) // 8
            space = inst.clamp(min=0) if dbvh.two_level else torch.zeros_like(inst)
            col = pair_col[space, g.clamp(max=pair_col.shape[1] - 1)]
            ok = is_tri & (col >= 0)
            colc = col.clamp(min=0)[:, None].expand(-1, REF_TILE)
            t8 = pair_t[rows, colc]
            k8 = pair_k[rows, colc]
            won = ok[:, None] & (t8 < t_ref) & (k8 >= 0)
            t_ref = torch.where(won, t8, t_ref)
            gk = torch.where(won, k8.to(torch.int32), gk)
            iout = torch.where(won, inst[:, None].to(torch.int32)
                               .expand(-1, REF_TILE), iout)

        if dbvh.two_level and bool(is_inst.any()):
            stack[ar, sp.clamp(max=cap - 1)] = torch.where(
                enter, torch.full_like(cur, sent), stack[ar, sp.clamp(max=cap - 1)])
            sp = sp + enter.long()
            m = inst16[torch.where(enter, iid, torch.zeros_like(iid))]
            sel = enter[:, None]
            new_o = [m[:, 4 * a, None] * wo[0] + m[:, 4 * a + 1, None] * wo[1]
                     + m[:, 4 * a + 2, None] * wo[2] + m[:, 4 * a + 3, None]
                     for a in range(3)]
            new_d = [m[:, 4 * a, None] * wd[0] + m[:, 4 * a + 1, None] * wd[1]
                     + m[:, 4 * a + 2, None] * wd[2] for a in range(3)]
            back = is_restore[:, None]
            for a in range(3):
                ro[a] = torch.where(sel, new_o[a], torch.where(back, wo[a], ro[a]))
                rdir[a] = torch.where(sel, new_d[a], torch.where(back, wd[a], rdir[a]))
            rr = [safe_rcp(c) for c in rdir]
            inst = torch.where(enter, iid, torch.where(is_restore, -1, inst))
            nxt = torch.where(enter, m[:, 12].round().long(), nxt)

        pop = live & (nxt == _DONE) & (sp > 0)
        top = stack[ar, (sp - 1).clamp(min=0)]
        nxt = torch.where(pop, top, nxt)
        sp = sp - pop.long()
        cur = torch.where(live, nxt, cur)
    t = torch.where(gk >= 0, t_ref, t_max[rows])
    return t, gk, iout


def plain_traverse_bf16(dbvh: DenseBVH, o, d, t_max, closest: bool,
                        band: float = NEAR_BAND):
    """The plain PyTorch version of kernel B2, on any device.

    A brute force over every triangle leaf of each object space (instances
    in order), with the kernel's per-lane box gate, re-origin, bf16
    arithmetic, sweep lanes (ray i sweeps as lane i mod 128) and in-group
    tie rules. Across groups it goes in group order and keeps a candidate
    only if strictly smaller, as the kernel does in its visit order.

    Closest mode returns (t, gk, inst, near_tie): the kernel's raw outputs
    (t = t_max, gk = inst = -1 where nothing was accepted; inst = -1 for
    single-level tables) and the lanes where the order groups are visited
    in may pick another winner. On those near lanes the winner is the one
    the reference TPU kernel's walk picks (``_tile_walk``: each
    REF_TILE-ray tile of the launch walks with one stack, nearer child by
    the tile's smallest entry first), so that on the CPU the port picks
    what the JAX package picks, exact bf16 ties across groups included;
    kernel B2 walks each ray alone (nearer child by its own entry) and may
    pick another winner there. A traversal visits a group only if its
    leaf's f32 slab test passes (the node box, which may be an ulp tighter
    than the ``glo`` box of the lane gate) with an entry before the running
    best (t_max at first). So the winning group can be skipped, or an equal
    candidate met first, only if the ray misses the winner's leaf-node box,
    or another group's best or t_max lies within ``band`` (relative) after
    the later of the winner's t and its group's box entry. (An apron hit can
    lie before its group's box entry.)

    Occlusion mode returns (cert, unc, near_tmax): the certain and the
    uncertain (apron-zone) accept masks, and the lanes with an accept from
    a group whose leaf-node box the ray misses, or whose bf16 t or box entry
    lies within ``band`` below t_max or beyond it: there the kernel's f32
    slab test may prune the accepting group.
    """
    PLAIN_CALLS["closest" if closest else "any"] += 1
    _check_tables(dbvh, o.device)
    dev = o.device
    B = o.shape[0]
    K = bf16_constants(dev)
    bf = torch.bfloat16
    nodes = dbvh.nodes16.detach().cpu().numpy().reshape(-1, NODE_F)
    if dbvh.two_level:
        inst_rows = dbvh.inst16.detach().cpu().numpy().reshape(-1, INST_F)
        spaces = [(iid, int(np.rint(inst_rows[iid, 12])))
                  for iid in range(dbvh.n_instances)]
    else:
        spaces = [(-1, 0)]
    tables: dict[int, dict] = {}
    lane = torch.remainder(torch.arange(B, device=dev), LEAF_W)
    inf = torch.tensor(float("inf"), device=dev)

    best_t = torch.full((B,), float("inf"), device=dev)   # smallest group best
    second_t = best_t.clone()                              # second smallest
    best_tn = torch.zeros((B,), device=dev)               # its group's box entry
    best_out = torch.zeros((B,), dtype=torch.bool, device=dev)  # misses its leaf box
    best_gk = torch.full((B,), -1, dtype=torch.int32, device=dev)
    best_i = torch.full((B,), -1, dtype=torch.int32, device=dev)
    cert = torch.zeros((B,), dtype=torch.bool, device=dev)
    unc = torch.zeros_like(cert)
    near = torch.zeros_like(cert)
    budget = trace._pair_budget(dev)
    # closest: each lane's best candidate t and key per (space, group)
    # pair, for the reference walk on near lanes (_tile_walk)
    n_all = dbvh.groups_bf.shape[0] // BF_ROWS
    pair_col = torch.full((len(spaces), n_all), -1, dtype=torch.int64, device=dev)
    pair_t, pair_k, n_pairs = [], [], 0

    for si, (iid, root) in enumerate(spaces):
        if root not in tables:
            tables[root] = _space_table(dbvh, root, nodes)
        tab = tables[root]
        n_cand = tab["slot"].shape[0]
        if n_cand == 0:
            continue
        if closest:
            gids = torch.as_tensor(tab["groups"], dtype=torch.int64, device=dev)
            pair_col[si, gids] = n_pairs + torch.arange(tab["n_groups"], device=dev)
            n_pairs += tab["n_groups"]
            pt = torch.full((B, tab["n_groups"]), float("inf"), device=dev)
            pk = torch.full((B, tab["n_groups"]), -1, dtype=torch.int32, device=dev)
            pair_t.append(pt)
            pair_k.append(pk)
        if iid >= 0:
            m = dbvh.inst16[iid * INST_F: iid * INST_F + 12]
            wx, wy, wz = o[:, 0], o[:, 1], o[:, 2]
            wdx, wdy, wdz = d[:, 0], d[:, 1], d[:, 2]
            oo = (m[0] * wx + m[1] * wy + m[2] * wz + m[3],
                  m[4] * wx + m[5] * wy + m[6] * wz + m[7],
                  m[8] * wx + m[9] * wy + m[10] * wz + m[11])
            dd = (m[0] * wdx + m[1] * wdy + m[2] * wdz,
                  m[4] * wdx + m[5] * wdy + m[6] * wdz,
                  m[8] * wdx + m[9] * wdy + m[10] * wdz)
        else:
            oo = (o[:, 0], o[:, 1], o[:, 2])
            dd = (d[:, 0], d[:, 1], d[:, 2])
        glo, nb = tab["glo"], tab["node_box"]
        lo = [glo[None, :, a] for a in range(3)]
        hi = [glo[None, :, 4 + a] for a in range(3)]
        nlo = [nb[None, :, a] for a in range(3)]
        nhi = [nb[None, :, 3 + a] for a in range(3)]
        slot = tab["slot"]
        rc = max(1, budget // n_cand)
        for r0 in range(0, B, rc):
            rs = slice(r0, min(B, r0 + rc))
            R = rs.stop - rs.start
            oc = [c[rs, None] for c in oo]
            dc = [c[rs, None] for c in dd]
            rd = [safe_rcp(c) for c in dc]
            # f32 re-origin at the group box entry and the per-lane box gate
            t0 = [(lo[a] - oc[a]) * rd[a] for a in range(3)]
            t1 = [(hi[a] - oc[a]) * rd[a] for a in range(3)]
            tn_g = torch.maximum(torch.maximum(
                torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                torch.minimum(t0[2], t1[2]))
            tn_g = torch.clamp(tn_g, min=0.0)                    # (R, G)
            tf_g = torch.minimum(torch.minimum(
                torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                torch.maximum(t0[2], t1[2]))
            bm = ((tn_g <= tf_g) & (tf_g >= 0.0)).to(bf)[:, slot]  # (R, K)
            # the leaf's own node box, as the traversal's slab test sees it
            n0 = [(nlo[a] - oc[a]) * rd[a] for a in range(3)]
            n1 = [(nhi[a] - oc[a]) * rd[a] for a in range(3)]
            tn_n = torch.maximum(torch.maximum(
                torch.minimum(n0[0], n1[0]), torch.minimum(n0[1], n1[1])),
                torch.minimum(n0[2], n1[2]))
            tf_n = torch.minimum(torch.minimum(
                torch.maximum(n0[0], n1[0]), torch.maximum(n0[1], n1[1])),
                torch.maximum(n0[2], n1[2]))
            leaf_out = ~((tn_n <= tf_n) & (tf_n > 0.0))          # (R, G)
            o3 = [(oc[a] + tn_g * dc[a] - lo[a]).to(bf)[:, slot] for a in range(3)]
            d3 = [c.to(bf) for c in dc]
            tn16 = tn_g.to(bf)[:, slot]
            comps = tab["comps"][lane[rs]]                       # (R, 9, K)
            tt, m, r_in, muv = _bf16_mt(o3, d3, comps.unbind(1), K)
            m = m * bm
            t_glob = tn16 + tt
            one, zero = K["1"], K["0"]
            tm = t_max[rs, None]
            if closest:
                m = m * torch.maximum(torch.minimum(t_glob * K["1e4"], one), zero)
                pen = one + K["0.05"] * (one - r_in)
                t_cand = (torch.maximum(t_glob, zero) * pen
                          + (one - m) * K["1e30"])
                tc = t_cand.float()
                tc = torch.where(tc < 9e29, tc, inf)
                # this space's winner: smallest t, then first group, then
                # the largest key of that group (a later k, then band 1)
                tmin = tc.min(dim=1).values
                rank = torch.where(tc == tmin[:, None], tab["rank"][None, :],
                                   torch.iinfo(torch.int64).max)
                j = rank.argmin(dim=1)
                take = tmin < best_t[rs]
                best_tn[rs] = torch.where(
                    take, tn_g.gather(1, slot[j][:, None])[:, 0], best_tn[rs])
                best_out[rs] = torch.where(
                    take, leaf_out.gather(1, slot[j][:, None])[:, 0], best_out[rs])
                best_gk[rs] = torch.where(take, tab["key"][j].to(torch.int32),
                                          best_gk[rs])
                best_i[rs] = torch.where(take, torch.full_like(best_i[rs], iid),
                                         best_i[rs])
                # group bests: the two smallest over all groups seen so far
                gbest = torch.full((R, tab["n_groups"]), float("inf"), device=dev)
                gbest = gbest.scatter_reduce(1, slot[None, :].expand(R, -1), tc,
                                             "amin")
                # each group's winner: its smallest t, then its largest key
                gmin = gbest[:, slot]
                kk = torch.where((tc == gmin) & (tc < inf), tab["key"][None, :], -1)
                pt[rs] = gbest
                pk[rs] = torch.full_like(gbest, -1, dtype=torch.int64).scatter_reduce(
                    1, slot[None, :].expand(R, -1), kk, "amax").to(torch.int32)
                two = torch.topk(torch.cat([gbest, best_t[rs, None],
                                            second_t[rs, None]], 1),
                                 2, dim=1, largest=False).values
                best_t[rs] = two[:, 0]
                second_t[rs] = two[:, 1]
            else:
                tmax16 = tm.to(bf)
                mt = (torch.maximum(torch.minimum(t_glob * K["1e4"], one), zero)
                      * torch.maximum(torch.minimum((tmax16 - t_glob) * K["1e4"],
                                                    one), zero))
                m_cert = torch.maximum(torch.minimum((muv - K["apron"]) * K["1e4"],
                                                     one), zero)
                acc = m * mt
                cert[rs] |= ((m * m_cert * mt).float() > 0.5).any(dim=1)
                unc[rs] |= (acc.float() > 0.5).any(dim=1)
                late = torch.maximum(t_glob.float(), tn_g[:, slot])
                near[rs] |= ((acc.float() > 0)
                             & ((late >= tm * (1.0 - band))
                                | leaf_out[:, slot])).any(dim=1)
    if not closest:
        return cert, unc, near
    found = best_t < t_max
    t = torch.where(found, best_t, t_max)
    gk = torch.where(found, best_gk, -1)
    inst = torch.where(found, best_i, -1)
    near = found & (best_out | (torch.minimum(second_t, t_max)
                                <= torch.maximum(best_t, best_tn) * (1.0 + band)))
    if bool(near.any()):
        tiles = torch.unique(torch.nonzero(near).flatten() // REF_TILE)
        tw, gw, iw = _tile_walk(dbvh, o, d, t_max, torch.cat(pair_t, 1),
                                torch.cat(pair_k, 1), pair_col, tiles)
        rows = (tiles[:, None] * REF_TILE
                + torch.arange(REF_TILE, device=dev)[None, :]).flatten()
        keep = rows < B
        rows, tw, gw, iw = rows[keep], tw.flatten()[keep], gw.flatten()[keep], \
            iw.flatten()[keep]
        sel = near[rows]
        rows, tw, gw, iw = rows[sel], tw[sel], gw[sel], iw[sel]
        t[rows], gk[rows], inst[rows] = tw, gw, iw
    return t, gk, inst, near


def _check_rays(dbvh: DenseBVH, o, d, t_max):
    trace._check_rays(dbvh, o, d, t_max)
    _check_tables(dbvh, o.device)


def _call_bf16(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """Kernel B2 (CUDA) or its plain version (CPU). Closest: (t, gk, inst);
    occlusion: (cert, unc)."""
    _check_rays(dbvh, o, d, t_max)
    count_lanes(t_max)
    if o.device.type == "cuda":
        return _launch(dbvh, o, d, t_max, closest)
    if o.device.type == "cpu":
        return plain_traverse_bf16(dbvh, o, d, t_max, closest)[:-1]
    raise ValueError(f"no traversal for device {o.device}")


# ---------------------------------------------------------------------------
# Winner decode
# ---------------------------------------------------------------------------

def _winner_slot(gk):
    """(group, period c, lane slot of the winning triangle) of winner keys
    in the order the kernel saw them (ray i swept as lane i mod 128)."""
    gkc = gk.clamp(min=0).long()
    band = gkc % 2
    rest = gkc // 2
    k = rest % 64
    g8l = rest // 64
    g = g8l // 8
    c = torch.ones_like(g) << (g8l % 8)
    shift = (band * c) // 2
    lane = torch.arange(gk.shape[0], device=gk.device) % LEAF_W
    slot = torch.remainder(lane - k - shift, LEAF_W)
    return g, c, slot


def _decode_fast(dbvh: DenseBVH, tb, gk, inst) -> Hit:
    """Winner prim only (one gather per ray from ``pids_c``) and the
    kernel's bf16 t, u = v = 0: for callers that refine the hit themselves
    (the integrator's refine_hit)."""
    B = tb.shape[0]
    g, c, slot = _winner_slot(gk)
    if dbvh.pids_c is not None:
        C = dbvh.pids_c.shape[0] // (dbvh.groups_bf.shape[0] // BF_ROWS)
        prim_local = torch.round(take_rows(dbvh.pids_c, g * C + (slot & (c - 1))))
    else:
        gflat = dbvh.groups.reshape(-1)
        prim_local = torch.round(take_rows(gflat, (g * GROUP_ROWS + 9) * LEAF_W + slot))
    prim_local = prim_local.to(torch.int32)
    found = (gk >= 0) & (prim_local >= 0)
    inst0 = inst.clamp(min=0)
    base = take_rows(dbvh.prim_base, inst0.long())
    zero = torch.zeros((B,), dtype=torch.float32, device=tb.device)
    return Hit(t=torch.where(found, tb, torch.full_like(tb, BVH_FAR)),
               u=zero, v=zero.clone(),
               prim=torch.where(found, prim_local + base, -1).to(torch.int32),
               inst=torch.where(found, inst0, -1).to(torch.int32))


def _decode_refine(dbvh: DenseBVH, o, d, t_max, tb, gk, inst) -> Hit:
    """Exact f32 hit record of the winner (the reference's default window of
    one triangle, REFINE_WIN = 1): its Möller-Trumbore with the f32 kernel's
    predicate. An apron winner whose exact test misses by less than the
    apron keeps the hit with clamped barycentrics; beyond it, it is a miss."""
    B = o.shape[0]
    g, _, slot = _winner_slot(gk)
    gflat = dbvh.groups.reshape(-1)
    row = lambda i: take_rows(gflat, (g * GROUP_ROWS + i) * LEAF_W + slot)
    prims = torch.round(row(9)).to(torch.int32)
    v0 = torch.stack([row(0), row(1), row(2)], dim=-1)
    e1 = torch.stack([row(3), row(4), row(5)], dim=-1)
    e2 = torch.stack([row(6), row(7), row(8)], dim=-1)
    if dbvh.two_level:
        a = take_rows(dbvh.inst16.reshape(-1, INST_F), inst.clamp(min=0).long())
        A = a[:, 0:12].reshape(B, 3, 4)
        oo = torch.einsum("bij,bj->bi", A[:, :, 0:3], o) + A[:, :, 3]
        dd = torch.einsum("bij,bj->bi", A[:, :, 0:3], d)
    else:
        oo, dd = o, d
    p = torch.linalg.cross(dd, e2, dim=-1)
    det = torch.sum(e1 * p, dim=-1)
    inv = 1.0 / torch.where(torch.abs(det) > 1e-9, det, torch.ones_like(det))
    tv = oo - v0
    u = torch.sum(tv * p, dim=-1) * inv
    q = torch.linalg.cross(tv, e1, dim=-1)
    v = torch.sum(dd * q, dim=-1) * inv
    t = torch.sum(e2 * q, dim=-1) * inv
    min_uv = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    found = ((gk >= 0) & (torch.abs(det) > 1e-9) & (t > 0.0) & (t < t_max)
             & (prims >= 0) & (min_uv > -APRON))
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.minimum(torch.clamp(v, min=0.0), torch.clamp(1.0 - u, min=0.0))
    inst0 = inst.clamp(min=0)
    base = take_rows(dbvh.prim_base, inst0.long())
    zero = torch.zeros_like(u)
    return Hit(t=torch.where(found, t, torch.full_like(t, BVH_FAR)),
               u=torch.where(found, u, zero), v=torch.where(found, v, zero),
               prim=torch.where(found, prims + base, -1).to(torch.int32),
               inst=torch.where(found, inst0, -1).to(torch.int32))


def _decode(dbvh, tb, gk, inst, refine, o, d, t_max) -> Hit:
    if refine == "fast":
        return _decode_fast(dbvh, tb, gk, inst)
    return _decode_refine(dbvh, o, d, t_max, tb, gk, inst)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _far(o):
    return torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)


def intersect_closest_bf16(dbvh: DenseBVH, o, d, t_max=None, *,
                           refine="exact") -> Hit:
    """Closest hit through the bf16 engine. refine="exact": the winner's
    exact f32 record; refine="fast": prim only, t = the kernel's bf16 t,
    u = v = 0 (the integrator refines the hit itself)."""
    t_max = _far(o) if t_max is None else t_max
    tb, gk, inst = _call_bf16(dbvh, o, d, t_max, closest=True)
    return _decode(dbvh, tb, gk, inst, refine, o, d, t_max)


def _resolve_uncertain(dbvh: DenseBVH, o, d, t_max, cert, unc, presorted):
    """Occluded = certain, or uncertain and not certain with an exact f32
    occlusion (kernel B1) on those lanes alone (t_max masked to 0 elsewhere).
    The retest always runs, with no host read; where no lane needs it, it
    gives ``cert``. ``presorted`` rays are traced in the order given, so
    that lanes without a retest leave at the root together; other rays are
    co-sorted first."""
    need = unc & ~cert
    tm = torch.where(need, t_max, torch.zeros_like(t_max))
    if presorted:
        occ = trace.intersect_any_dense(dbvh, o, d, tm)
    else:
        occ = trace.sorted_any_dense(dbvh, o, d, tm)
    return cert | (need & occ)


def intersect_any_bf16(dbvh: DenseBVH, o, d, t_max) -> torch.Tensor:
    """Occlusion: kernel-certain (inside a triangle by more than the apron)
    or an exact f32 verdict on the apron-uncertain lanes."""
    cert, unc = _call_bf16(dbvh, o, d, t_max, closest=False)
    return _resolve_uncertain(dbvh, o, d, t_max, cert, unc, presorted=False)


def sorted_closest_bf16(dbvh: DenseBVH, o, d, t_max=None, *,
                        sort_mode="octant_major", refine="exact") -> Hit:
    """Closest hit on sorted rays (``trace.morton_key``'s ``sort_mode``),
    decoded in sorted order (the winner key depends on the lane the kernel
    saw), scattered back."""
    t_max = _far(o) if t_max is None else t_max
    perm, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, t_max, sort_mode)
    tb, gk, inst = _call_bf16(dbvh, o_s, d_s, tm_s, closest=True)
    hit = _decode(dbvh, tb, gk, inst, refine, o_s, d_s, tm_s)
    return Hit(*(trace._unsort(perm, x) for x in hit))


def sorted_any_bf16(dbvh: DenseBVH, o, d, t_max, *,
                    sort_mode="octant_major") -> torch.Tensor:
    """Occlusion on sorted rays; the uncertain lanes are resolved in sorted
    order (no second sort), then the verdict is scattered back."""
    perm, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, t_max, sort_mode)
    cert, unc = _call_bf16(dbvh, o_s, d_s, tm_s, closest=False)
    occ = _resolve_uncertain(dbvh, o_s, d_s, tm_s, cert, unc, presorted=True)
    return trace._unsort(perm, occ)
