"""The wave engine's fused cascade level (``ops/wave_level.py``) of the port
vs the JAX package, on the CPU: its plain version ``plain_run_level`` vs the
JAX package's ``_wave_run`` (``dense="mt"``) from the same ``_wave_state``,
``max_waves``, the wrapper's checks and the engine's use of it; and, where a
GPU is present (``cuda``-marked), the kernel ``csrc/wave_level.cu`` vs the
plain version.

Tolerances, as tests/test_torch_wave.py: active flags and found masks
equal, t within 1e-6 relative (XLA:CPU may contract the multiply-adds of
Möller-Trumbore that PyTorch keeps apart), prim equal except where a
float64 brute force sees a t-tie, occlusion exactly equal. Between the
port's own versions (a wave at a time vs the loop, the kernel vs the plain
version): bit for bit. Inputs are made with numpy from a seed."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.ops import traverse_packet as jtp  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import leaf_mt, wave_level, wave_scan  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as ttp  # noqa: E402
from tests.test_torch_trace import _rays, _ties  # noqa: E402
from tests.test_torch_wave import T_RTOL, TILE, _reset, _tiles, wave_scene  # noqa: E402,F401

N_RAYS = 4096      # 256 tiles of 16
LEVEL = dict(node_steps=8, leaf_cap=4, leaf_size=16)


def _inputs(closest, seed):
    """Rays toward the small scene; in occlusion mode tmax in [0.5, 6] with a
    fifth of it zero (dead rays)."""
    o, d = _rays(N_RAYS, seed=seed)
    gen = np.random.default_rng(seed)
    if closest:
        tmax = np.full((N_RAYS,), 1e30, np.float32)
    else:
        tmax = np.where(gen.uniform(size=N_RAYS) < 0.2, 0.0,
                        gen.uniform(0.5, 6.0, size=N_RAYS)).astype(np.float32)
    return o, d, tmax


def _port_state(o, d, tmax, closest, tile=TILE):
    to, td, (ttm,), _, _ = ttp._pad_tiles(torch.from_numpy(o), torch.from_numpy(d),
                                          [torch.from_numpy(tmax)], tile)
    return ttp._wave_state(to, td, ttm, 48, closest)


def _keys(closest):
    return wave_level.LEVEL_KEYS["closest" if closest else "any"]


def _assert_same_state(got, want, closest, what=""):
    for k in _keys(closest):
        assert torch.equal(got[k], want[k]), f"{what}{k}"


@pytest.fixture(scope="module")
def jax_level(wave_scene):
    """JAX's _wave_run (dense="mt") jitted once per (mode, min_active)."""
    js = wave_scene[0]
    cache = {}

    def get(closest, min_active):
        if (closest, min_active) not in cache:
            cache[(closest, min_active)] = jax.jit(lambda st: jtp._wave_run(
                js.bvh, st, closest=closest, dense="mt", min_active=min_active, **LEVEL))
        return cache[(closest, min_active)]
    return get


@pytest.mark.parametrize("min_active_div", [0, 8])
@pytest.mark.parametrize("closest", [True, False])
def test_plain_run_level_vs_jax(wave_scene, jax_level, closest, min_active_div):
    """plain_run_level vs JAX's _wave_run from the same _wave_state, both
    modes, min_active 0 (run until no tile is active) and T//8 (the
    cascade's exit): active flags equal, found masks equal, t within 1e-6
    relative, prim equal outside t-ties, occlusion equal; the scan and B4's
    plain versions ran once a wave and ``st`` is left alone."""
    js, ts, tri, _ = wave_scene
    o, d, tmax = _inputs(closest, seed=31 + int(closest))
    (jo, jd, jtm), _ = _tiles(o, d, tmax, TILE)
    jst = jtp._wave_state(js.bvh, jo, jd, jtm, 48, closest)
    tst = _port_state(o, d, tmax, closest)
    T = tst["cur"].shape[0]
    min_active = T // min_active_div if min_active_div else 0
    want = {k: np.asarray(v) for k, v in jax_level(closest, min_active)(jst).items()}
    before = {k: tst[k].clone() for k in _keys(closest)}
    _reset()
    got = wave_level.plain_run_level(ts.bvh, tst, closest=closest, min_active=min_active,
                                     **LEVEL)
    mode = "closest" if closest else "any"
    waves = ttp.WAVES[mode]
    assert waves > 0 and wave_level.PLAIN_CALLS == {"level": 1}
    assert wave_scan.PLAIN_CALLS["scan"] == waves and leaf_mt.PLAIN_CALLS[mode] == waves
    assert sum(wave_level.LAUNCHES.values()) == 0
    _assert_same_state(tst, before, closest, "st touched: ")
    np.testing.assert_array_equal(got["active"].numpy(), want["active"])
    n_active = int(got["active"].sum())
    assert n_active <= min_active
    if closest:
        gp, wp = got["prim"].numpy().reshape(-1), want["prim"].reshape(-1)
        np.testing.assert_array_equal(gp >= 0, wp >= 0)
        hit = gp >= 0
        assert hit.mean() > 0.2
        gt, wt = got["t"].numpy().reshape(-1), want["t"].reshape(-1)
        np.testing.assert_allclose(gt[hit], wt[hit], rtol=T_RTOL)
        np.testing.assert_array_equal(gt[~hit], wt[~hit])
        assert not ((gp != wp) & ~_ties(tri, o, d)).any()
    else:
        occ = got["occ"].numpy()
        np.testing.assert_array_equal(occ, want["occ"])
        assert 0.05 < occ.mean() < 0.8 and not occ.reshape(-1)[tmax == 0.0].any()


@pytest.mark.parametrize("closest", [True, False])
def test_max_waves(wave_scene, closest):
    """max_waves=1 is one iteration of the loop (plain_node_scan ->
    plain_leaf_intersect / plain_leaf_any -> _tile_update) bit for bit;
    max_waves=0 runs none; a level run one wave at a time until its test
    fails equals the whole level, in state and in waves."""
    _, ts, _, _ = wave_scene
    bvh = ts.bvh
    o, d, tmax = _inputs(closest, seed=33 + int(closest))
    st = _port_state(o, d, tmax, closest)
    _reset()
    one = wave_level.plain_run_level(bvh, st, closest=closest, min_active=0, max_waves=1,
                                     **LEVEL)
    mode = "closest" if closest else "any"
    assert ttp.WAVES[mode] == 1
    cur, sp, stack, nleaf, leafbuf, active = wave_scan.plain_node_scan(bvh, st, 8, 4)
    manual = dict(st, cur=cur, sp=sp, stack=stack, active=active)
    rays = (st["o_t"], st["d_t"], st["tmax"])
    if closest:
        new = leaf_mt.plain_leaf_intersect(*rays, st["t"], st["u"], st["v"], st["prim"],
                                           leafbuf, nleaf, bvh.tris, 16)
        manual.update(zip(("t", "u", "v", "prim"), new))
    else:
        manual["occ"] = leaf_mt.plain_leaf_any(*rays, st["occ"], leafbuf, nleaf, bvh.tris, 16)
    manual = wave_level._tile_update(manual, closest=closest)
    _assert_same_state(one, manual, closest)
    assert int(nleaf.sum()) > 0

    none = wave_level.plain_run_level(bvh, st, closest=closest, min_active=0, max_waves=0,
                                      **LEVEL)
    _assert_same_state(none, st, closest)
    assert ttp.WAVES[mode] == 1

    whole = wave_level.plain_run_level(bvh, st, closest=closest, min_active=0, **LEVEL)
    n_whole = ttp.WAVES[mode] - 1
    step, n_step = st, 0
    while bool(step["active"].any()):
        step = wave_level.plain_run_level(bvh, step, closest=closest, min_active=0,
                                          max_waves=1, **LEVEL)
        n_step += 1
    _assert_same_state(step, whole, closest)
    assert n_step == n_whole > 1


def test_run_level_in_place_and_engine_levels(wave_scene):
    """run_level on CPU tensors runs the plain version and updates the state
    in place; the engine runs one level per cascade width (256 -> 32 tiles,
    then the last level) through the plain version on the CPU."""
    _, ts, _, _ = wave_scene
    o, d, tmax = _inputs(True, seed=35)
    st = _port_state(o, d, tmax, True)
    want = wave_level.plain_run_level(ts.bvh, st, closest=True, min_active=32, **LEVEL)
    _reset()
    tensors = {k: st[k] for k in _keys(True)}
    got = wave_level.run_level(ts.bvh, st, closest=True, min_active=32, **LEVEL)
    assert got is st and all(st[k] is x for k, x in tensors.items())
    _assert_same_state(st, want, True)
    assert wave_level.PLAIN_CALLS == {"level": 1}
    assert wave_level.LAUNCHES == {"closest": 0, "any": 0}

    _reset()
    hit = ttp.intersect_closest_wave(ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                                     tile=TILE)
    assert ttp.LEVELS == {"closest": 2, "any": 0}
    assert wave_level.PLAIN_CALLS == {"level": 2}
    assert ttp.collect_waves()["closest"] == ttp.WAVES["closest"] > 0
    assert (hit.prim >= 0).any()


def test_run_level_checks(wave_scene):
    """run_level refuses a tensor on another device, a wrong dtype, a
    non-contiguous tensor, a tile width its block does not take and
    dense="woop" (which keeps the per-wave loop)."""
    _, ts, _, _ = wave_scene
    o, d, tmax = _inputs(True, seed=36)

    def run(st, **kw):
        wave_level.run_level(ts.bvh, st, closest=True, min_active=0, max_waves=1,
                             **LEVEL, **kw)

    st = _port_state(o, d, tmax, True)
    st["t"] = st["t"].to("meta")
    with pytest.raises(ValueError, match="is on"):
        run(st)
    st = _port_state(o, d, tmax, True)
    st["prim"] = st["prim"].long()
    with pytest.raises(TypeError, match="prim"):
        run(st)
    st = _port_state(o, d, tmax, True)
    T, W = st["t"].shape
    strided = torch.empty((W, T)).t()
    strided.copy_(st["t"])
    st["t"] = strided
    with pytest.raises(ValueError, match="contiguous"):
        run(st)
    for tile in (4, 12, 2048):
        with pytest.raises(ValueError, match="tile width"):
            run(_port_state(o, d, tmax, True, tile=tile))
    with pytest.raises(ValueError, match="dense"):
        run(_port_state(o, d, tmax, True), dense="woop")
    run(_port_state(o, d, tmax, True, tile=32))   # a width it takes


@pytest.mark.cuda
def test_wave_level_kernel_vs_plain_on_gpu(wave_scene):
    """The fused kernel vs plain_run_level on card tensors, both modes, at
    tile widths 128 and 16: every wave (max_waves=1, the test on the host)
    bit-equal to the plain wave, and whole levels (min_active 0 and T//8)
    bit-equal to the plain level with as many waves (runs where a GPU is
    present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    _, ts, _, _ = wave_scene
    bvh = ts.bvh.to(dev)
    for closest in (True, False):
        mode = "closest" if closest else "any"
        o, d, tmax = _inputs(closest, seed=37)
        for tile in (128, 16):
            to, td, (ttm,), _, _ = ttp._pad_tiles(
                torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                [torch.from_numpy(tmax).to(dev)], tile)
            st = ttp._wave_state(to, td, ttm, 48, closest)
            start = {k: v.clone() for k, v in st.items()}
            waves = 0
            while bool(st["active"].any()):
                want = wave_level.plain_run_level(bvh, st, closest=closest, min_active=0,
                                                  max_waves=1, **LEVEL)
                wave_level.run_level(bvh, st, closest=closest, min_active=0, max_waves=1,
                                     **LEVEL)
                _assert_same_state(st, want, closest, f"wave {waves}: ")
                waves += 1
            T = st["cur"].shape[0]
            for min_active in (0, T // 8):
                s = {k: v.clone() for k, v in start.items()}
                ttp.collect_waves()
                n0 = ttp.WAVES[mode]
                wave_level.run_level(bvh, s, closest=closest, min_active=min_active, **LEVEL)
                n_kernel = ttp.collect_waves()[mode] - n0
                want = wave_level.plain_run_level(bvh, start, closest=closest,
                                                  min_active=min_active, **LEVEL)
                n_plain = ttp.WAVES[mode] - n0 - n_kernel
                _assert_same_state(s, want, closest, f"level {min_active}: ")
                assert n_kernel == n_plain and (min_active or n_kernel == waves)
    assert wave_scan.truncated_pushes(dev) == 0
