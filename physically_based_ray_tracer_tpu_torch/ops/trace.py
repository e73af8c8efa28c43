"""Exact f32 dense-BVH traversal; counterpart of ``physically_based_ray_tracer_tpu/ops/pallas_trace.py``.

The wrappers take rays on one device and dispatch on it:
  * CUDA tensors launch the hand-written kernel ``csrc/traverse_f32.cu``
    (built at first use by ``ops/_build.py``) or raise;
  * CPU tensors run ``plain_traverse``, a vectorised brute force over the
    same tables, with the same arithmetic.
There is no fallback between the two. ``LAUNCHES`` counts kernel launches
and ``PLAIN_CALLS`` counts calls of the plain version, so that a run can show
which of them it went through.

``sorted_closest_dense`` / ``sorted_any_dense`` co-sort the rays by a
Morton key first (coherent warps; ``morton_key``, octant-major unless
``sort_mode`` names another of its modes), as the JAX package's wrappers do
for its tiles, and scatter the results back to the caller's order.
"""

from __future__ import annotations

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import (ABSENT,
                                                             GROUP_ROWS,
                                                             INST_F, LEAF_W,
                                                             NODE_F,
                                                             DenseBVH)
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit

LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}
# per-device int32 count of rays that hit the step bound or the stack cap
_TRUNCATED: dict[torch.device, torch.Tensor] = {}
# what the kernels' counting instantiations count, in counter order
WORK_KEYS = ("node_steps", "tri_tests", "leaf_visits")
# operations per counted unit, by type, from the arithmetic of
# csrc/traverse_common.cuh (B1 and B3): a node step is two slab tests of 26
# (6 sub, 6 mul, 5 min/max for the entry, 5 for the exit, 4 compares); a
# triangle test is mt_f32 (48 arithmetic, 5 accept compares) and the t-clip
# compare; a leaf visit only loads
UNIT_OPS = {"node_steps": {"f32": 52}, "tri_tests": {"f32": 54}}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def truncated_rays(device, counts=_TRUNCATED) -> int:
    """Rays the kernel cut short on ``device`` so far (synchronises);
    ``counts`` is the kernel's per-device counter store."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = counts.get(device)
    return 0 if c is None else int(c.item())


def max_steps(dbvh: DenseBVH) -> int:
    """The TPU kernel's step bound: 8 * nodes * (instances + 1) + 64."""
    n_inst = dbvh.n_instances if dbvh.two_level else 0
    return min(8 * dbvh.n_nodes * (n_inst + 1) + 64, 2**31 - 1)


def _check_rays(dbvh: DenseBVH, o, d, t_max):
    dev = o.device
    B = o.shape[0]
    for name, x, shape in (("o", o, (B, 3)), ("d", d, (B, 3)),
                           ("t_max", t_max, (B,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, o on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
    for name in ("nodes16", "groups", "inst16", "leaf_rec"):
        x = getattr(dbvh, name)
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"dbvh.{name} must be contiguous float32 on {dev}")


def launch_args(dbvh: DenseBVH, o, d, t_max, stack_cap: int, counts: dict):
    """What every traversal kernel launch needs, checked: contiguous rays,
    the device's truncation counter (created in ``counts`` on first use)
    and the current stream. Refuses a table whose stack need exceeds the
    kernel's ``stack_cap`` or whose node table or leaf tables are not 16-byte
    aligned (the kernels load nodes, B1's leaf records and B2's band pairs
    as 16-byte vectors)."""
    if dbvh.stack_need > stack_cap:
        raise ValueError(f"BVH needs a traversal stack of {dbvh.stack_need} "
                         f"entries; the kernel holds {stack_cap}")
    for name in ("nodes16", "leaf_rec", "groups_bf2"):
        x = getattr(dbvh, name)
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"dbvh.{name} must be 16-byte aligned")
    dev = o.device
    trunc = counts.get(dev)
    if trunc is None:
        trunc = counts[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return o.contiguous(), d.contiguous(), t_max.contiguous(), trunc, stream


def run_counting(fn, error_string, lead: tuple, outs: tuple, trunc, stream,
                 unit_ops: dict, keys: tuple = WORK_KEYS) -> dict:
    """Launch a kernel's counting instantiation ``fn(*lead, *outs, trunc,
    counters, stream)`` and return its counts (``keys``, in the kernel's
    counter order) and, under ``"ops"``, the operations by type that
    ``unit_ops`` gives them. These launches serve the bound in
    ``chip_smoke.py``; they are not main-path launches and no ``LAUNCHES``
    count includes them."""
    counters = torch.zeros((len(keys),), dtype=torch.int64, device=trunc.device)
    err = fn(*lead, *(x.data_ptr() for x in outs), trunc.data_ptr(),
             counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("counting launch failed: " + error_string(err).decode())
    work = dict(zip(keys, counters.tolist()))
    ops: dict[str, int] = {}
    for key, per_unit in unit_ops.items():
        for kind, n in per_unit.items():
            ops[kind] = ops.get(kind, 0) + work[key] * n
    return {**work, "ops": ops}


def _lead(dbvh: DenseBVH, lib, o, d, t_max):
    """Checked launch arguments of B1: (table and ray pointers, B, max
    steps), the truncation counter and the stream."""
    o, d, t_max, trunc, stream = launch_args(dbvh, o, d, t_max,
                                             lib.pbrt_trace_stack_cap(), _TRUNCATED)
    lead = (dbvh.nodes16.data_ptr(), dbvh.leaf_rec.data_ptr(), record_stride(dbvh),
            dbvh.inst16.data_ptr(), int(dbvh.two_level), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), o.shape[0], max_steps(dbvh))
    return lead, trunc, stream


def record_stride(dbvh: DenseBVH) -> int:
    """Leaf records per group in ``dbvh.leaf_rec`` (C, the largest period)."""
    return dbvh.leaf_rec.shape[0] // dbvh.n_groups


def count_work(dbvh: DenseBVH, o, d, t_max, closest: bool) -> dict:
    """Node steps, triangle tests and leaf visits of one B1 launch on these
    CUDA rays, and their operations (see ``run_counting``)."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    _check_rays(dbvh, o, d, t_max)
    lib = _build.load("traverse_f32")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    return run_counting(lib.pbrt_trace_count_f32, lib.pbrt_trace_error_string,
                        (*lead, int(closest)), raw_outputs(o.shape[0], o.device),
                        trunc, stream, UNIT_OPS)


def raw_outputs(B: int, dev) -> tuple:
    """Empty (t, u, v, prim, inst, occ) of a counting launch of either mode."""
    f = lambda: torch.empty((B,), dtype=torch.float32, device=dev)
    i = lambda: torch.empty((B,), dtype=torch.int32, device=dev)
    return f(), f(), f(), i(), i(), torch.empty((B,), dtype=torch.bool, device=dev)


def _launch(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """Launch the CUDA kernel on the current stream; returns raw outputs."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    lib = _build.load("traverse_f32")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    B, dev = o.shape[0], o.device
    if closest:
        t = torch.empty((B,), dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        prim = torch.empty((B,), dtype=torch.int32, device=dev)
        inst = torch.empty_like(prim)
        err = lib.pbrt_trace_closest_f32(
            *lead, t.data_ptr(), u.data_ptr(), v.data_ptr(),
            prim.data_ptr(), inst.data_ptr(), trunc.data_ptr(), stream)
        out = (t, u, v, prim, inst)
    else:
        occ = torch.empty((B,), dtype=torch.bool, device=dev)
        err = lib.pbrt_trace_any_f32(*lead, occ.data_ptr(), trunc.data_ptr(),
                                     stream)
        out = occ
    if err != 0:
        raise RuntimeError("traverse_f32 launch failed: "
                           + lib.pbrt_trace_error_string(err).decode())
    LAUNCHES["closest" if closest else "any"] += 1
    return out


# ---------------------------------------------------------------------------
# Plain version: brute force over the same tables
# ---------------------------------------------------------------------------

def _leaves(nodes: np.ndarray, root: int) -> list[tuple[int, int]]:
    """(group, period c) of every triangle leaf under ``root`` (one BLAS or
    a single-level tree; instance leaves are not followed)."""
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        for side in range(2):
            code = int(np.rint(nodes[n, 12 + side]))
            if code == ABSENT:
                continue
            if code >= 0:
                stack.append(code)
            else:
                v = -(code + 1)
                if v % 2 == 0:
                    gv = v // 2
                    out.append((gv // 8, 1 << (gv % 8)))
    return out


def _leaf_triangles(dbvh: DenseBVH, root: int, nodes: np.ndarray):
    """(v0, e1, e2) as (K, 3) each and the mesh-local prim id (K,) of the
    distinct live triangles under ``root`` (slots 0..c-1 of each leaf)."""
    gi, si = [], []
    for g, c in _leaves(nodes, root):
        gi.extend([g] * c)
        si.extend(range(c))
    dev = dbvh.groups.device
    grp = dbvh.groups.reshape(-1, GROUP_ROWS, LEAF_W)
    rows = grp[torch.as_tensor(gi, dtype=torch.int64, device=dev), :10,
               torch.as_tensor(si, dtype=torch.int64, device=dev)]   # (K, 10)
    rows = rows[rows[:, 9] >= 0]          # drop the zero padding triangles
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9].to(torch.int32)


def _mt(o3, d3, tri):
    """Möller-Trumbore of rays (R,1) against triangles (1,K), operation for
    operation as in the kernel. Returns (t, u, v, ok) of shape (R, K)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0, e1, e2 = tri
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > 1e-9
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
    return tt, uu, vv, ok


def _pair_budget(device) -> int:
    """Ray x triangle pairs per brute-force chunk (bounds temporaries)."""
    return 1 << (25 if device.type == "cuda" else 20)


def plain_traverse(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """The plain PyTorch version of the kernel, on any device.

    Closest mode returns (t, u, v, prim_local, inst, t_second): the kernel's
    raw outputs (t = t_max and prim = inst = -1 where nothing was hit; inst
    = -1 for single-level tables) plus the second-smallest candidate t
    (BVH_FAR if none), which marks t-ties where the winner may legitimately
    differ from the kernel's. Among equal t it keeps the first candidate in
    leaf order. Occlusion mode returns the occluded mask."""
    PLAIN_CALLS["closest" if closest else "any"] += 1
    return brute_force_tables(dbvh, o, d, t_max, closest)


def brute_force_tables(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """``plain_traverse``'s computation, uncounted: every triangle of every
    object space against every ray. Kernels B1 and B3 compute this one
    function, so it is the plain version of both (each counts its own calls)."""
    dev = o.device
    B = o.shape[0]
    nodes = dbvh.nodes16.detach().cpu().numpy().reshape(-1, NODE_F)
    if dbvh.two_level:
        inst_rows = dbvh.inst16.detach().cpu().numpy().reshape(-1, INST_F)
        spaces = [(iid, int(np.rint(inst_rows[iid, 12])))
                  for iid in range(dbvh.n_instances)]
    else:
        spaces = [(-1, 0)]
    tri_cache: dict[int, tuple] = {}

    far = torch.full((B,), BVH_FAR, dtype=torch.float32, device=dev)
    best_t = t_max.clone()
    best_u = torch.zeros((B,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_p = torch.full((B,), -1, dtype=torch.int32, device=dev)
    best_i = torch.full((B,), -1, dtype=torch.int32, device=dev)
    first_t = far.clone()     # smallest / second-smallest candidate t
    second_t = far.clone()
    occ = torch.zeros((B,), dtype=torch.bool, device=dev)
    budget = _pair_budget(dev)

    for iid, root in spaces:
        if root not in tri_cache:
            tri_cache[root] = _leaf_triangles(dbvh, root, nodes)
        v0, e1, e2, pid = tri_cache[root]
        K = v0.shape[0]
        if K == 0:
            continue
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
        kc = min(K, 65536)
        rc = max(1, budget // kc)
        for r0 in range(0, B, rc):
            rs = slice(r0, min(B, r0 + rc))
            o3 = tuple(c[rs, None] for c in oo)
            d3 = tuple(c[rs, None] for c in dd)
            tm = t_max[rs, None]
            for k0 in range(0, K, kc):
                ks = slice(k0, min(K, k0 + kc))
                tt, uu, vv, ok = _mt(o3, d3, (v0[ks], e1[ks], e2[ks]))
                hit = ok & (tt < tm)
                if not closest:
                    occ[rs] |= hit.any(dim=1)
                    continue
                tc = torch.where(hit, tt, torch.full_like(tt, BVH_FAR))
                c1, j1 = torch.min(tc, dim=1)
                tc.scatter_(1, j1[:, None], BVH_FAR)
                c2 = torch.min(tc, dim=1).values
                take = c1 < best_t[rs]
                sel = lambda x: torch.gather(x, 1, j1[:, None])[:, 0]
                best_t[rs] = torch.where(take, c1, best_t[rs])
                best_u[rs] = torch.where(take, sel(uu), best_u[rs])
                best_v[rs] = torch.where(take, sel(vv), best_v[rs])
                best_p[rs] = torch.where(take, pid[ks][j1], best_p[rs])
                best_i[rs] = torch.where(take, torch.full_like(best_i[rs], iid),
                                         best_i[rs])
                # merge the two candidate pairs {first, second} and {c1, c2}
                f, s = first_t[rs], second_t[rs]
                second_t[rs] = torch.minimum(torch.maximum(f, c1),
                                             torch.minimum(s, c2))
                first_t[rs] = torch.minimum(f, c1)
    if not closest:
        return occ
    return best_t, best_u, best_v, best_p, best_i, second_t


def _traverse(dbvh: DenseBVH, o, d, t_max, closest: bool):
    _check_rays(dbvh, o, d, t_max)
    if o.device.type == "cuda":
        return _launch(dbvh, o, d, t_max, closest)
    if o.device.type == "cpu":
        out = plain_traverse(dbvh, o, d, t_max, closest)
        return out[:5] if closest else out
    raise ValueError(f"no traversal for device {o.device}")


def intersect_closest_dense(dbvh: DenseBVH, o, d, t_max=None) -> Hit:
    """Closest-hit traversal; o, d: (B, 3). Returns a Hit with prim in the
    scene's global order (mesh-local ids + prim_base) and inst = the
    instance id (0 for single-level tables)."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    return to_hit(dbvh, *_traverse(dbvh, o, d, t_max, closest=True))


def to_hit(dbvh: DenseBVH, t, u, v, prim, inst) -> Hit:
    """Raw traversal outputs (mesh-local prim, inst -1 when single-level)
    -> Hit: prim mapped to the scene's global order through prim_base,
    t = BVH_FAR and prim = inst = -1 on a miss."""
    found = prim >= 0
    inst0 = inst.clamp(min=0)
    base = dbvh.prim_base[inst0.clamp(max=dbvh.prim_base.shape[0] - 1).long()]
    zero = torch.zeros_like(u)
    return Hit(t=torch.where(found, t, torch.full_like(t, BVH_FAR)),
               u=torch.where(found, u, zero),
               v=torch.where(found, v, zero),
               prim=torch.where(found, prim + base, -1).to(torch.int32),
               inst=torch.where(found, inst0, -1).to(torch.int32))


def intersect_any_dense(dbvh: DenseBVH, o, d, t_max) -> torch.Tensor:
    """Occlusion query: True where a hit exists with t in (0, t_max)."""
    return _traverse(dbvh, o, d, t_max, closest=False)


SORT_MODES = ("octant_major", "morton_major", "six_d")


def morton_key(o, d, scene_lo, scene_hi, dead=None, mode="octant_major"):
    """Coherence sort key of a ray batch (uint32 values, held in int64 so
    that every bit sorts as unsigned). Modes, as the JAX package's:

    * "octant_major": the 3-bit direction octant over a 21-bit origin
      Morton code (the default; the mode the traversal wrappers use unless
      told otherwise);
    * "morton_major": the coarse 12 Morton bits, then the octant, then the
      9 fine Morton bits;
    * "six_d": the 15 coarse Morton bits, a 2-bit-per-axis direction code
      (6 bits), then the 6 fine Morton bits.

    ``dead`` lanes (e.g. tmax == 0) sort to the back: bit 24 (bit 27 in
    "six_d")."""
    ext = torch.clamp(scene_hi - scene_lo, min=1e-20)
    q = torch.clamp(((o - scene_lo) / ext) * 127.0, 0.0, 127.0).to(torch.int64)

    def spread(x):  # interleave 7 bits with stride 3
        out = torch.zeros_like(x)
        for i in range(7):
            out = out | (((x >> i) & 1) << (3 * i))
        return out

    morton = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    octant = ((d[..., 0] > 0).to(torch.int64)
              | ((d[..., 1] > 0).to(torch.int64) << 1)
              | ((d[..., 2] > 0).to(torch.int64) << 2))
    if mode == "octant_major":
        key = (octant << 21) | morton
        dead_shift = 24
    elif mode == "morton_major":
        key = ((morton >> 9) << 12) | (octant << 9) | (morton & 0x1FF)
        dead_shift = 24
    elif mode == "six_d":
        qd = torch.clamp((d * 0.5 + 0.5) * 3.0, 0.0, 3.0).to(torch.int64)

        def spread2(x):  # 2 bits, stride 3
            return (x & 1) | (((x >> 1) & 1) << 3)

        dmorton = (spread2(qd[..., 0]) | (spread2(qd[..., 1]) << 1)
                   | (spread2(qd[..., 2]) << 2))
        key = ((morton >> 6) << 12) | (dmorton << 6) | (morton & 0x3F)
        dead_shift = 27
    else:
        raise ValueError(f"unknown morton_order mode: {mode}")
    if dead is not None:
        key = key | (dead.to(torch.int64) << dead_shift)
    return key


def _cosort_rays(dbvh: DenseBVH, o, d, t_max, mode="octant_major"):
    """Stable sort by morton_key (``mode``, dead lanes last); returns (perm,
    o, d, t_max) in sorted order."""
    key = morton_key(o, d, dbvh.world_lo, dbvh.world_hi, dead=t_max <= 0.0, mode=mode)
    perm = torch.sort(key, stable=True).indices
    return perm, o[perm], d[perm], t_max[perm]


def _unsort(perm, x):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def sorted_closest_dense(dbvh: DenseBVH, o, d, t_max=None, *,
                         sort_mode="octant_major") -> Hit:
    """Closest hit on octant+Morton-sorted rays (bounce/shadow wavefronts);
    ``sort_mode`` picks morton_key's mode."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    perm, o_s, d_s, tm_s = _cosort_rays(dbvh, o, d, t_max, sort_mode)
    hit = intersect_closest_dense(dbvh, o_s, d_s, tm_s)
    return Hit(*(_unsort(perm, x) for x in hit))


def sorted_any_dense(dbvh: DenseBVH, o, d, t_max, *, sort_mode="octant_major") -> torch.Tensor:
    perm, o_s, d_s, tm_s = _cosort_rays(dbvh, o, d, t_max, sort_mode)
    return _unsort(perm, intersect_any_dense(dbvh, o_s, d_s, tm_s))
