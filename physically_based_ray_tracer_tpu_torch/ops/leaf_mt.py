"""Kernel B4: the wave engine's dense tile x leaf Möller-Trumbore; counterpart of ``physically_based_ray_tracer_tpu/ops/pallas_mt.py``.

One wave of the wave engine (``ops/traverse_packet.py``) buffers up to L
leaves per ray tile, then tests every ray of the tile against every live
triangle of those leaves, in leaf order and then slot order:

  * ``leaf_intersect`` (closest hit, the TPU kernel's own function) keeps,
    per ray, the first triangle whose t beats ``min(t, tmax)``;
  * ``leaf_any`` (the occlusion half of the wave's dense phase) marks a ray
    occluded when a live triangle is hit at 0 < t < tmax.

Both update their state tensors in place and return them. They dispatch on
the tensors' device: CUDA tensors launch the hand-written kernel
``csrc/leaf_mt.cu`` (built at first use by ``ops/_build.py``; counted in
``LAUNCHES``) or raise; CPU tensors run the plain version, the JAX package's
XLA dense phase in torch (``mt_dense`` over the gathered rows, then the
ordered take; counted in ``PLAIN_CALLS``). There is no fallback between the
two. The math helpers (``mt_dense``, ``leaf_columns``) are the JAX
package's ``traverse_packet`` ones, kept here beside the kernel they check.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.bvh.types import decode_leaf

LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}
# operations per triangle test by mode, from csrc/leaf_mt.cu: mt_f32 of
# csrc/traverse_common.cuh (48 arithmetic, 5 accept compares) and the t-clip
# compare; closest mode also takes the min of the best t and tmax
UNIT_OPS = {"closest": {"tri_tests": {"f32": 55}}, "any": {"tri_tests": {"f32": 54}}}
# bytes per ray of one launch: o, d, tmax read; the state read and written
RAY_BYTES = 28
STATE_BYTES = {"closest": 16, "any": 1}
# the kernel stages a tile's triangles in a (9, 128) shared-memory block
MAX_WIDTH = 1024
MAX_LEAF_SIZE = 128


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _gather_rows(arr, idx):
    """``jnp.take(arr, idx, axis=0, mode="clip")``."""
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]


def mt_dense(o_t, d_t, rows, t_clip):
    """Dense Möller-Trumbore with explicit components, in the reference's
    operation order.

    o_t, d_t: (T, W, 3) rays; rows: (T, K, 9) packed (v0, e1, e2) triangles;
    t_clip: (T, W) current clip distance. Returns (t, u, v, hit) each (T, W, K).
    """
    ox, oy, oz = (o_t[:, :, None, i] for i in range(3))      # (T, W, 1)
    dx, dy, dz = (d_t[:, :, None, i] for i in range(3))
    v0x, v0y, v0z = (rows[:, None, :, i] for i in range(3))  # (T, 1, K)
    e1x, e1y, e1z = (rows[:, None, :, 3 + i] for i in range(3))
    e2x, e2y, e2z = (rows[:, None, :, 6 + i] for i in range(3))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > 1e-9
    inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < t_clip[:, :, None]))
    return t, u, v, hit


def leaf_columns(leafbuf, nleaf, leaf_size):
    """Expand the (T, L) leaf buffer into flat dense-test columns: slots
    (T, L*K) triangle slot ids and the col_ok validity mask."""
    first, count = decode_leaf(leafbuf)   # filler -1 decodes to count 0
    L, K = leafbuf.shape[1], leaf_size
    lidx = torch.arange(L, dtype=torch.int32, device=leafbuf.device)
    has = lidx[None, :] < nleaf[:, None]                          # (T, L)
    k = torch.arange(K, dtype=torch.int32, device=leafbuf.device)
    slots = first[:, :, None] + k[None, None, :]                  # (T, L, K)
    col_ok = has[:, :, None] & (k[None, None, :] < count[:, :, None])
    return slots.reshape(-1, L * K), col_ok.reshape(-1, L * K)


def ordered_take(kt, ku, kv, khit, slots, t, u, v, prim, tmax):
    """The wave's closest-hit take over the columns, in column order: a
    column replaces the ray's hit when it is a hit and its t beats
    ``min(t, tmax)``. Computed as its closed form, the first column that
    attains the smallest such t (the sequential strict-less loop keeps
    exactly that one). Returns new (t, u, v, prim)."""
    clip = torch.minimum(t, tmax)
    ok = khit & (kt < clip[:, :, None])
    masked = torch.where(ok, kt, torch.full_like(kt, float("inf")))
    k = torch.argmin(masked, dim=2, keepdim=True)                  # first minimum
    take = torch.gather(ok, 2, k)[..., 0]
    pick = lambda x: torch.gather(x, 2, k)[..., 0]
    cols = torch.gather(slots[:, None, :].expand_as(kt), 2, k)[..., 0]
    return (torch.where(take, pick(kt), t), torch.where(take, pick(ku), u),
            torch.where(take, pick(kv), v), torch.where(take, cols, prim))


def plain_leaf_intersect(o_t, d_t, tmax_t, t, u, v, prim, leafbuf, nleaf, tris,
                         leaf_size):
    """The plain version of the closest entry (the XLA dense phase); returns
    new (t, u, v, prim)."""
    PLAIN_CALLS["closest"] += 1
    slots, col_ok = leaf_columns(leafbuf, nleaf, leaf_size)
    rows = _gather_rows(tris, torch.where(col_ok, slots, 0))
    kt, ku, kv, khit = mt_dense(o_t, d_t, rows, torch.minimum(t, tmax_t))
    return ordered_take(kt, ku, kv, khit & col_ok[:, None, :], slots,
                        t, u, v, prim, tmax_t)


def plain_leaf_any(o_t, d_t, tmax_t, occ, leafbuf, nleaf, tris, leaf_size):
    """The plain version of the occlusion entry; returns the new mask."""
    PLAIN_CALLS["any"] += 1
    slots, col_ok = leaf_columns(leafbuf, nleaf, leaf_size)
    rows = _gather_rows(tris, torch.where(col_ok, slots, 0))
    _, _, _, khit = mt_dense(o_t, d_t, rows, tmax_t)
    return occ | torch.any(khit & col_ok[:, None, :], dim=2)


def count_work(leafbuf, nleaf, width: int, leaf_size: int, mode: str) -> dict:
    """The work one launch of ``mode`` ("closest" or "any") needs on these
    leaf buffers, for its bound (synchronises): the triangle tests (every
    ray of a tile against every live triangle of its buffered leaves) with
    the operations ``UNIT_OPS`` gives them, and the bytes it must move:
    every tile's nleaf; of each tile with a buffered leaf, its live leaf
    codes and its rays and state (``RAY_BYTES``, ``STATE_BYTES`` in and
    out); each distinct live triangle row once."""
    slots, col_ok = leaf_columns(leafbuf, nleaf, leaf_size)
    tests = int(col_ok.sum()) * width
    live_tiles = int((nleaf > 0).sum())
    tris = int(torch.unique(slots[col_ok]).numel())
    nbytes = (4 * nleaf.shape[0] + 4 * int(nleaf.sum())
              + live_tiles * width * (RAY_BYTES + 2 * STATE_BYTES[mode]) + 36 * tris)
    return {"tri_tests": tests, "live_tiles": live_tiles, "distinct_tris": tris,
            "bytes": nbytes,
            "ops": {kind: tests * n for kind, n in UNIT_OPS[mode]["tri_tests"].items()}}


def _check(o_t, d_t, tmax_t, state, leafbuf, nleaf, tris, leaf_size):
    """Refuses what the kernel does not take; ``state`` lists the (T, W)
    state tensors as (name, tensor, dtype)."""
    T, W, _ = o_t.shape
    f32, i32 = torch.float32, torch.int32
    want = [("o_t", o_t, (T, W, 3), f32), ("d_t", d_t, (T, W, 3), f32),
            ("tmax", tmax_t, (T, W), f32),
            *[(n, x, (T, W), dtype) for n, x, dtype in state],
            ("leafbuf", leafbuf, (T, leafbuf.shape[-1]), i32), ("nleaf", nleaf, (T,), i32),
            ("tris", tris, (tris.shape[0], 9), f32)]
    for name, x, shape, dtype in want:
        if x.device != o_t.device:
            raise ValueError(f"{name} is on {x.device}, o_t on {o_t.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not 1 <= leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {leaf_size} outside 1..{MAX_LEAF_SIZE}")


def _launch(closest, o_t, d_t, tmax_t, state, leafbuf, nleaf, tris, leaf_size):
    from physically_based_ray_tracer_tpu_torch.ops import _build

    T, W, _ = o_t.shape
    if W > MAX_WIDTH:
        raise ValueError(f"tile width {W} above the kernel's {MAX_WIDTH}")
    tensors = [o_t, d_t, tmax_t, *state, leafbuf, nleaf, tris]
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("leaf_mt: every tensor must be contiguous")
    lib = _build.load("leaf_mt")
    stream = torch.cuda.current_stream(o_t.device).cuda_stream
    lead = [o_t.data_ptr(), d_t.data_ptr(), tmax_t.data_ptr()]
    tail = [leafbuf.data_ptr(), nleaf.data_ptr(), tris.data_ptr(), tris.shape[0],
            T, W, leafbuf.shape[1], leaf_size, stream]
    if closest:
        err = lib.pbrt_leaf_mt_closest(*lead, *(x.data_ptr() for x in state), *tail)
    else:
        err = lib.pbrt_leaf_mt_any(*lead, state[0].data_ptr(), *tail)
    if err != 0:
        raise RuntimeError("leaf_mt launch failed: " + lib.pbrt_leaf_mt_error_string(err).decode())
    LAUNCHES["closest" if closest else "any"] += 1


def leaf_intersect(o_t, d_t, tmax_t, t, u, v, prim, leafbuf, nleaf, tris, *,
                   leaf_size: int = 16):
    """Dense leaf phase, closest hit; the signature of the JAX package's
    ``leaf_intersect_pallas``.

    o_t, d_t: (T, W, 3) f32; tmax_t, t, u, v: (T, W) f32; prim: (T, W) i32
    (triangle slot, -1 = none); leafbuf: (T, L) i32 leaf codes (-1 empty);
    nleaf: (T,) i32 live slots; tris: (P, 9) f32. Updates t, u, v, prim in
    place and returns them."""
    _check(o_t, d_t, tmax_t, [("t", t, torch.float32), ("u", u, torch.float32),
                              ("v", v, torch.float32), ("prim", prim, torch.int32)],
           leafbuf, nleaf, tris, leaf_size)
    if o_t.device.type == "cuda":
        _launch(True, o_t, d_t, tmax_t, [t, u, v, prim], leafbuf, nleaf, tris, leaf_size)
    elif o_t.device.type == "cpu":
        new = plain_leaf_intersect(o_t, d_t, tmax_t, t, u, v, prim, leafbuf, nleaf,
                                   tris, leaf_size)
        for x, y in zip((t, u, v, prim), new):
            x.copy_(y)
    else:
        raise ValueError(f"no leaf kernel for device {o_t.device}")
    return t, u, v, prim


def leaf_any(o_t, d_t, tmax_t, occ, leafbuf, nleaf, tris, *, leaf_size: int = 16):
    """Dense leaf phase, occlusion: ``occ`` (T, W) bool |= a live triangle
    is hit at 0 < t < tmax. Updates ``occ`` in place and returns it."""
    _check(o_t, d_t, tmax_t, [("occ", occ, torch.bool)], leafbuf, nleaf, tris, leaf_size)
    if o_t.device.type == "cuda":
        _launch(False, o_t, d_t, tmax_t, [occ], leafbuf, nleaf, tris, leaf_size)
    elif o_t.device.type == "cpu":
        occ.copy_(plain_leaf_any(o_t, d_t, tmax_t, occ, leafbuf, nleaf, tris, leaf_size))
    else:
        raise ValueError(f"no leaf kernel for device {o_t.device}")
    return occ
