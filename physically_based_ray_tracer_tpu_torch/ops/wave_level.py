"""One cascade level of the wave engine in one launch; counterpart of ``_wave_run`` in ``physically_based_ray_tracer_tpu/ops/traverse_packet.py`` for ``dense="mt"``.

A level of the wave engine (``ops/traverse_packet.py``) repeats WAVES while
more than ``min_active`` tiles are active (any tile, for ``min_active`` 0),
testing before the first wave:

* the node scan (``ops/wave_scan.py``): ``node_steps`` steps a tile,
  buffering up to ``leaf_cap`` leaves;
* the dense phase (kernel B4's function, ``ops/leaf_mt.py``) over the
  buffered leaves;
* the tile update (``_tile_update``): each tile's pruning distance and, in
  occlusion mode, the retirement of tiles whose rays are all occluded or
  dead.

``run_level`` dispatches on the state's device: CUDA launches the fused
kernel ``csrc/wave_level.cu`` (one cooperative launch for the whole level,
the loop test on the card, no host sync; counted in ``LAUNCHES``) or
raises; the CPU runs ``plain_run_level``, the per-wave loop in torch with
the test read on the host (``PLAIN_CALLS``). Both update the state in place
and run the same waves. ``max_waves`` caps the waves of one call, for the
checks and tests. Waves are counted per mode in ``WAVES``: the plain loop
adds to it as it goes; the kernel adds to a per-device counter on the card,
folded into ``WAVES`` by ``collect_waves`` (which synchronises), so that a
level never waits for the host.
"""

from __future__ import annotations

import ctypes

import torch

from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays
from physically_based_ray_tracer_tpu_torch.ops import leaf_mt, wave_scan

MODES = ("closest", "any")
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"level": 0}
WAVES = {"closest": 0, "any": 0}
# the kernel's block (csrc/wave_level.cu THREADS): it takes a tile width
# that is a power of two from MIN_WIDTH (the lanes of a scan step's six box
# pieces, rounded up) to it
THREADS = 1024
MIN_WIDTH = 8
# per device: waves the kernel ran by mode (int64), and the two slots of its
# exit-test counter (zero between launches)
_WAVES_DEV: dict[torch.device, torch.Tensor] = {}
_SLOTS: dict[torch.device, torch.Tensor] = {}
# how the last launch ran: node table in shared memory, blocks
LAST_LAUNCH = {"smem_nodes": None, "grid": None}
# the tile state a level changes, by mode
LEVEL_KEYS = {"closest": ("cur", "sp", "stack", "active", "t_tile", "t", "u", "v", "prim"),
              "any": ("cur", "sp", "stack", "active", "t_tile", "occ")}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, WAVES):
        for k in d:
            d[k] = 0
    for c in _WAVES_DEV.values():
        c.zero_()


def collect_waves() -> dict:
    """``WAVES`` with the waves the kernel ran on every card since the last
    call (or ``reset_counts``) folded in; synchronises."""
    for c in _WAVES_DEV.values():
        for k, n in zip(MODES, c.tolist()):
            WAVES[k] += n
        c.zero_()
    return dict(WAVES)


def _tile_update(st, *, closest):
    """After the dense phase: the tiles' pruning distance and, in occlusion
    mode, the retirement of tiles whose rays are all occluded or dead."""
    if closest:
        st["t_tile"] = torch.amax(torch.minimum(st["t"], st["tmax"]), dim=1)
    else:
        occ, tmax = st["occ"], st["tmax"]
        all_occ = torch.all(occ | (tmax <= 0.0), dim=1)
        st["active"] = st["active"] & ~all_occ
        st["t_tile"] = torch.amax(torch.where(~occ, tmax, 0.0), dim=1)
    return st


def plain_run_level(bvh: BVHArrays, st: dict, *, closest: bool, node_steps: int,
                    leaf_cap: int, leaf_size: int, min_active: int,
                    max_waves: int | None = None) -> dict:
    """The plain version: the per-wave loop (``plain_node_scan`` ->
    ``plain_leaf_intersect`` / ``plain_leaf_any`` -> ``_tile_update``), its
    test read on the host. Returns the new state; ``st`` is not touched."""
    PLAIN_CALLS["level"] += 1
    mode = "closest" if closest else "any"
    st = dict(st)
    waves = 0
    while ((max_waves is None or waves < max_waves)
           and int(st["active"].sum()) > min_active):
        cur, sp, stack, nleaf, leafbuf, active = wave_scan.plain_node_scan(
            bvh, st, node_steps, leaf_cap)
        st.update(cur=cur, sp=sp, stack=stack, active=active)
        rays = (st["o_t"], st["d_t"], st["tmax"])
        if closest:
            new = leaf_mt.plain_leaf_intersect(*rays, st["t"], st["u"], st["v"], st["prim"],
                                               leafbuf, nleaf, bvh.tris, leaf_size)
            st.update(zip(("t", "u", "v", "prim"), new))
        else:
            st["occ"] = leaf_mt.plain_leaf_any(*rays, st["occ"], leafbuf, nleaf, bvh.tris,
                                               leaf_size)
        st = _tile_update(st, closest=closest)
        WAVES[mode] += 1
        waves += 1
    return st


def _check(bvh: BVHArrays, st: dict, closest: bool, leaf_cap: int, leaf_size: int,
           node_steps: int, min_active: int, max_waves, dense: str) -> None:
    if dense != "mt":
        raise ValueError(f"dense={dense!r}: the fused level runs dense='mt' only "
                         "(the wave engine keeps its per-wave loop for 'woop')")
    T, W, _ = st["o_t"].shape
    S = st["stack"].shape[-1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    want = [("o_t", (T, W, 3), f32), ("d_t", (T, W, 3), f32), ("tmax", (T, W), f32),
            *[(k, (T, 3), f32) for k in ("o_lo", "o_hi", "rd_lo", "rd_hi")],
            ("t_tile", (T,), f32), ("cur", (T,), i32), ("sp", (T,), i32),
            ("stack", (T, S), i32), ("active", (T,), b8)]
    if closest:
        want += [("t", (T, W), f32), ("u", (T, W), f32), ("v", (T, W), f32),
                 ("prim", (T, W), i32)]
    else:
        want += [("occ", (T, W), b8)]
    tensors = [(k, st[k], shape, dtype) for k, shape, dtype in want]
    tensors += [("nodes_box", bvh.nodes_box, (bvh.n_nodes, 12), f32),
                ("nodes_child", bvh.nodes_child, (bvh.n_nodes, 2), i32),
                ("tris", bvh.tris, (bvh.tris.shape[0], 9), f32)]
    dev = st["cur"].device
    for name, x, shape, dtype in tensors:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the tile state on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"wave_level: {name} must be contiguous")
    if not MIN_WIDTH <= W <= THREADS or W & (W - 1):
        raise ValueError(f"tile width {W}: the kernel's {THREADS}-thread block takes a "
                         f"power of two from {MIN_WIDTH} to {THREADS}")
    if not 1 <= leaf_size <= leaf_mt.MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {leaf_size} outside 1..{leaf_mt.MAX_LEAF_SIZE}")
    if leaf_cap < 1 or node_steps < 0 or min_active < 0 or S < 1:
        raise ValueError(f"leaf_cap {leaf_cap}, node_steps {node_steps}, min_active "
                         f"{min_active}, stack depth {S}: want >= 1, >= 0, >= 0, >= 1")
    if max_waves is not None and max_waves < 0:
        raise ValueError(f"max_waves {max_waves} < 0")


def _device_counters(dev) -> tuple[torch.Tensor, torch.Tensor]:
    if dev not in _WAVES_DEV:
        _WAVES_DEV[dev] = torch.zeros((2,), dtype=torch.int64, device=dev)
        _SLOTS[dev] = torch.zeros((2,), dtype=torch.int64, device=dev)
    return _WAVES_DEV[dev], _SLOTS[dev]


def _launch(bvh: BVHArrays, st: dict, closest: bool, node_steps: int, leaf_cap: int,
            leaf_size: int, min_active: int, max_waves) -> None:
    from physically_based_ray_tracer_tpu_torch.ops import _build

    T, W, _ = st["o_t"].shape
    dev = st["cur"].device
    mode = "closest" if closest else "any"
    waves, slots = _device_counters(dev)
    lib = _build.load("wave_level")
    # t, u, v, prim, occ: the mode's own state, null for the other's
    state = ([st[k].data_ptr() for k in ("t", "u", "v", "prim")] + [None] if closest
             else [None] * 4 + [st["occ"].data_ptr()])
    smem_nodes, grid = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.pbrt_wave_level(
        bvh.nodes_box.data_ptr(), bvh.nodes_child.data_ptr(), bvh.n_nodes,
        *(st[k].data_ptr() for k in ("o_t", "d_t", "tmax", "o_lo", "o_hi", "rd_lo", "rd_hi",
                                     "t_tile", "cur", "sp", "stack", "active")),
        *state,
        bvh.tris.data_ptr(), bvh.tris.shape[0], T, W, st["stack"].shape[1], leaf_cap,
        leaf_size, node_steps, min(min_active, 2**31 - 1),
        -1 if max_waves is None else min(max_waves, 2**31 - 1),
        wave_scan._counter(dev).data_ptr(), slots.data_ptr(),
        waves.data_ptr() + waves.element_size() * MODES.index(mode), dev.index,
        ctypes.addressof(smem_nodes), ctypes.addressof(grid),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("wave_level launch failed: "
                           + lib.pbrt_wave_level_error_string(err).decode())
    LAST_LAUNCH.update(smem_nodes=bool(smem_nodes.value), grid=grid.value)
    LAUNCHES[mode] += 1


def run_level(bvh: BVHArrays, st: dict, *, closest: bool, node_steps: int, leaf_cap: int,
              leaf_size: int, min_active: int, max_waves: int | None = None,
              dense: str = "mt") -> dict:
    """Run one cascade level (at most ``max_waves`` waves) on the tile state
    ``st`` of ``traverse_packet._wave_state``: rays ``o_t``, ``d_t`` (T, W, 3)
    and ``tmax`` (T, W) f32, bounds ``o_lo``, ``o_hi``, ``rd_lo``, ``rd_hi``
    (T, 3) f32, and the state it updates in place (``LEVEL_KEYS``):
    ``t_tile`` (T,) f32, ``cur``, ``sp`` (T,) i32, ``stack`` (T, S) i32,
    ``active`` (T,) bool, and ``t``, ``u``, ``v`` (T, W) f32 + ``prim``
    (T, W) i32 (closest) or ``occ`` (T, W) bool (any). Returns ``st``."""
    _check(bvh, st, closest, leaf_cap, leaf_size, node_steps, min_active, max_waves, dense)
    dev = st["cur"].device
    if dev.type == "cuda":
        _launch(bvh, st, closest, node_steps, leaf_cap, leaf_size, min_active, max_waves)
    elif dev.type == "cpu":
        new = plain_run_level(bvh, st, closest=closest, node_steps=node_steps,
                              leaf_cap=leaf_cap, leaf_size=leaf_size,
                              min_active=min_active, max_waves=max_waves)
        for k in LEVEL_KEYS["closest" if closest else "any"]:
            st[k].copy_(new[k])
    else:
        raise ValueError(f"no wave level for device {dev}")
    return st
