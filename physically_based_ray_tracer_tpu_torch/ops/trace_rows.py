"""Row-parallel exact f32 traversal (``traversal="pallas_rows"``); counterpart
of ``physically_based_ray_tracer_tpu/ops/pallas_rows.py``.

Kernel B3 (``csrc/traverse_rows.cu``) computes kernel B1's function, the
exact per-ray closest hit or occlusion on B1's tables (``nodes16``,
``leaf_rec``, ``inst16``), and schedules it as the TPU row kernel does while
that pays: one traversal per group of co-sorted rays, with one shared stack.
On the TPU the group is a 128-lane row; here it is a warp of 32 rays, and
at the first node step where one of its rays would not take the warp's
step the warp splits and each ray walks on alone, as in B1. Where B3 and B1
both find a hit, t is bit-equal; prim and instance differ only on t-ties,
where visit order decides; occlusion is equal.

As in the JAX package, ``leaf_precision`` does not apply to this engine: it
always runs on the exact f32 tables.

The wrappers dispatch on the rays' device, as ``ops/trace.py`` does:
  * CUDA tensors launch kernel B3 (built at first use by ``ops/_build.py``)
    or raise;
  * CPU tensors run ``plain_traverse_rows``, which is B1's plain version
    (``trace.brute_force_tables``), counted here.
There is no fallback between the two. ``LAUNCHES`` counts kernel launches
and ``PLAIN_CALLS`` calls of the plain version.

``sorted_rows_closest`` / ``sorted_rows_any`` co-sort the rays first. The
JAX package sorts by ``morton_order(..., mode=sort_mode)`` + ``take`` and
scatters back with ``argsort``; ``jnp.argsort`` is stable on the same key,
so ``trace._cosort_rays`` (a stable sort by the same key) gives the same
permutation.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import DenseBVH
from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.ops import trace
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit

# kernel B3's stack entries per warp (STACK_CAP of csrc/traverse_common.cuh);
# the wrappers refuse a table that needs more on every device, and the CUDA
# launch checks the built kernel's own value
STACK_CAP = 64

# what the counting instantiation counts, in counter order: B1's three
# (the shared phase's node steps once per lane of the warp), and warps split
WORK_KEYS = (*trace.WORK_KEYS, "split_warps")
# the order-preserving integer image of the shared phase's nearer-child vote
# (order_keys): every float32 that is not a NaN, in increasing order, is
# number 0 (-inf) .. ORDERED_FLOATS - 1 (+inf), -0.0 just before +0.0
_NEG_FLOATS = 0x7F800001               # -inf .. -0.0
ORDERED_FLOATS = 2 * _NEG_FLOATS

LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}
# per-device int32 count of rays that hit the step bound or the stack cap
_TRUNCATED: dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def truncated_rays(device) -> int:
    """Rays kernel B3 cut short on ``device`` so far (synchronises)."""
    return trace.truncated_rays(device, _TRUNCATED)


def max_steps(dbvh: DenseBVH) -> int:
    """The TPU row kernel's step bound, 16 * nodes * (instances + 1) + 256,
    applied per warp."""
    n_inst = dbvh.n_instances if dbvh.two_level else 0
    return min(16 * dbvh.n_nodes * (n_inst + 1) + 256, 2**31 - 1)


def _lead(dbvh: DenseBVH, lib, o, d, t_max):
    """Checked launch arguments: (table and ray pointers, B, max steps),
    the truncation counter and the stream."""
    o, d, t_max, trunc, stream = trace.launch_args(
        dbvh, o, d, t_max, lib.pbrt_trace_rows_stack_cap(), _TRUNCATED)
    lead = (dbvh.nodes16.data_ptr(), dbvh.leaf_rec.data_ptr(), trace.record_stride(dbvh),
            dbvh.inst16.data_ptr(), int(dbvh.two_level), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), o.shape[0], max_steps(dbvh))
    return lead, trunc, stream


def _launch(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """Launch kernel B3 on the current stream; returns raw outputs as B1's
    wrapper does."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    lib = _build.load("traverse_rows")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    B, dev = o.shape[0], o.device
    if closest:
        t = torch.empty((B,), dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        prim = torch.empty((B,), dtype=torch.int32, device=dev)
        inst = torch.empty_like(prim)
        err = lib.pbrt_trace_closest_rows(
            *lead, t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
            inst.data_ptr(), trunc.data_ptr(), stream)
        out = (t, u, v, prim, inst)
    else:
        occ = torch.empty((B,), dtype=torch.bool, device=dev)
        err = lib.pbrt_trace_any_rows(*lead, occ.data_ptr(), trunc.data_ptr(), stream)
        out = occ
    if err != 0:
        raise RuntimeError("traverse_rows launch failed: "
                           + lib.pbrt_trace_rows_error_string(err).decode())
    LAUNCHES["closest" if closest else "any"] += 1
    return out


def count_work(dbvh: DenseBVH, o, d, t_max, closest: bool) -> dict:
    """Node steps, triangle tests and leaf visits of one B3 launch on these
    CUDA rays, the warps that split, and the operations (B1's arithmetic,
    ``trace.UNIT_OPS``). The shared phase's node steps are counted once per
    lane of the warp, idle lanes included, and every lane's triangle tests
    and leaf visits as it runs them: this is the work B3's schedule does,
    not the work its function (B1's) needs (see ``trace.run_counting``)."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    trace._check_rays(dbvh, o, d, t_max)
    lib = _build.load("traverse_rows")
    lead, trunc, stream = _lead(dbvh, lib, o, d, t_max)
    return trace.run_counting(lib.pbrt_trace_count_rows,
                              lib.pbrt_trace_rows_error_string,
                              (*lead, int(closest)),
                              trace.raw_outputs(o.shape[0], o.device), trunc, stream,
                              trace.UNIT_OPS, WORK_KEYS)


def plain_order_keys(x: torch.Tensor) -> torch.Tensor:
    """``order_key`` of ``csrc/traverse_rows.cu`` on float32 ``x``: int32
    keys in the floats' order, -0.0 and +0.0 one key (the float's bits if
    not negative, else its magnitude bits flipped)."""
    b = x.view(torch.int32)
    b = torch.where(b == -2**31, torch.zeros_like(b), b)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``order_key`` of contiguous float32 ``x`` on a CUDA
    device (``plain_order_keys`` on the CPU)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("order_keys takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return plain_order_keys(x)
    if x.device.type != "cuda":
        raise ValueError(f"no order_keys for device {x.device}")
    from physically_based_ray_tracer_tpu_torch.ops import _build

    lib = _build.load("traverse_rows")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    err = lib.pbrt_rows_order_keys(x.data_ptr(), out.data_ptr(), x.numel(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("order key launch failed: "
                           + lib.pbrt_trace_rows_error_string(err).decode())
    return out


def ordered_floats(start: int, n: int, device) -> torch.Tensor:
    """Floats number ``start`` .. ``start + n - 1`` of the non-NaN float32
    values in increasing order (see ``ORDERED_FLOATS``)."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    bits = torch.where(i < _NEG_FLOATS, 0xFF800000 - i, i - _NEG_FLOATS)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def order_key_mismatches(device, start: int = 0, count: int = ORDERED_FLOATS,
                         chunk: int = 1 << 27) -> dict:
    """Holds ``order_keys`` (the kernel on a CUDA device) against the float
    order on the ``count`` non-NaN float32 values from number ``start``, in
    chunks: for each pair of neighbours a < b (in float order) the keys must
    compare as torch compares the floats (``<`` and ``==``: -0.0 == +0.0),
    and equal ``plain_order_keys``. Neighbours in float order suffice: a key
    order that agrees on each of them agrees on every pair. Returns the
    pairs checked and the mismatches."""
    pairs = order = plain = 0
    for s0 in range(start, start + count - 1, chunk):
        n = min(chunk + 1, start + count - s0)
        x = ordered_floats(s0, n, device)
        k = order_keys(x)
        a, b, ka, kb = x[:-1], x[1:], k[:-1], k[1:]
        order += int(((a < b) != (ka < kb)).sum() + ((a == b) != (ka == kb)).sum())
        plain += int((k != plain_order_keys(x)).sum())
        pairs += n - 1
    return dict(pairs=pairs, order_mismatch=order, plain_mismatch=plain)


def plain_traverse_rows(dbvh: DenseBVH, o, d, t_max, closest: bool):
    """B3's plain version: B1's (``trace.brute_force_tables``, the same
    function), counted in this module's ``PLAIN_CALLS``. Returns what
    ``trace.plain_traverse`` returns."""
    PLAIN_CALLS["closest" if closest else "any"] += 1
    return trace.brute_force_tables(dbvh, o, d, t_max, closest)


def _traverse(dbvh: DenseBVH, o, d, t_max, closest: bool):
    trace._check_rays(dbvh, o, d, t_max)
    if dbvh.stack_need > STACK_CAP:
        raise ValueError(f"BVH needs a traversal stack of {dbvh.stack_need} "
                         f"entries; kernel B3 holds {STACK_CAP}")
    if o.device.type == "cuda":
        return _launch(dbvh, o, d, t_max, closest)
    if o.device.type == "cpu":
        out = plain_traverse_rows(dbvh, o, d, t_max, closest)
        return out[:5] if closest else out
    raise ValueError(f"no traversal for device {o.device}")


def rows_closest_dense(dbvh: DenseBVH, o, d, t_max=None) -> Hit:
    """Closest hit through kernel B3 (drop-in for
    ``trace.intersect_closest_dense``); o, d: (B, 3)."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    return trace.to_hit(dbvh, *_traverse(dbvh, o, d, t_max, closest=True))


def rows_any_dense(dbvh: DenseBVH, o, d, t_max) -> torch.Tensor:
    """Occlusion through kernel B3: True where a hit exists with t in
    (0, t_max)."""
    return _traverse(dbvh, o, d, t_max, closest=False)


def sorted_rows_closest(dbvh: DenseBVH, o, d, t_max=None, *,
                        sort_mode="octant_major") -> Hit:
    """Closest hit on co-sorted rays (``trace.morton_key``'s ``sort_mode``),
    scattered back."""
    if t_max is None:
        t_max = torch.full((o.shape[0],), BVH_FAR, dtype=o.dtype, device=o.device)
    perm, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, t_max, sort_mode)
    hit = rows_closest_dense(dbvh, o_s, d_s, tm_s)
    return Hit(*(trace._unsort(perm, x) for x in hit))


def sorted_rows_any(dbvh: DenseBVH, o, d, t_max, *, sort_mode="octant_major") -> torch.Tensor:
    perm, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, t_max, sort_mode)
    return trace._unsort(perm, rows_any_dense(dbvh, o_s, d_s, tm_s))
