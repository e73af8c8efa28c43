"""The wave engine (``traversal="wave"``) of the port vs the JAX package, on
the CPU: the classic BVH builders, kernel B4's plain version
(``ops/leaf_mt.py``) vs the Pallas kernel in interpret mode and the XLA
dense phase, the node scan's plain version (``ops/wave_scan.py``) vs
``_wave_node_scan``, the wave traversal and its sorted wrappers, and the
slice (``Renderer``) vs the JAX ``Renderer``.

Tolerances: tables byte for byte. t within 1e-6 relative (XLA:CPU may
contract the multiply-adds of Möller-Trumbore that PyTorch keeps apart; the
bit-equal counts are asserted where they hold). prim equal except where a
float64 brute force sees a t-tie; found masks and occlusion exactly equal;
images as tests/test_torch_render.py::_agree. Each JAX function is jitted
once per module (module-scoped fixtures), so the file compiles each XLA
program once."""

import dataclasses
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh import builder as jbuilder  # noqa: E402
from physically_based_ray_tracer_tpu.bvh import types as jtypes  # noqa: E402
from physically_based_ray_tracer_tpu.ops import traverse_packet as jtp  # noqa: E402
from physically_based_ray_tracer_tpu.ops.pallas_mt import leaf_intersect_pallas  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu.scene import scene as jscene_mod  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import builder as tbuilder  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import types as ttypes  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import (leaf_mt, trace, trace_bf16,  # noqa: E402
                                                       trace_rows, wave_scan)
from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as ttp  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import check_supported  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.test_torch_trace import _rays, _ties  # noqa: E402
from tests.torch_port import (SLICE_CFG, ensure_jax_native, instanced_parts,  # noqa: E402
                              instanced_scene, port_camera, port_config, port_scene)

T_RTOL = 1e-6
N_RAYS = 4096
TILE = 16          # 256 tiles: one level of the shrink cascade runs (256 -> 32)
WAVE_CFG = SLICE_CFG.replace(traversal="wave")


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the JAX package itself then falls back to numpy)")


@pytest.fixture
def jax_native():
    """g++ present and the JAX package's native builders loaded (the JAX
    package's own native build is what these tests compare with)."""
    _needs_gxx()
    ensure_jax_native()


def _same_bytes(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


BVH_FIELDS = ("nodes_box", "nodes_child", "tris", "prim_index", "tris_woop")


def _same_bvh(t, j):
    for f in BVH_FIELDS:
        _same_bytes(getattr(t, f), getattr(j, f), f)


def _reset():
    for m in (trace, trace_bf16, trace_rows, leaf_mt, wave_scan, ttp):
        m.reset_counts()


# ---------------------------------------------------------------------------
# the classic BVH
# ---------------------------------------------------------------------------

def _bench_parts():
    """bench.py's models and instances, in the JAX package's types."""
    sphere = jscene_mod.MeshModel.from_fat(make_sphere(radius=1.0, lat=32, lon=64),
                                           base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                           metalness=0.2)
    floor = jscene_mod.MeshModel.from_fat(
        make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8], [-8, -1, 8]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    instances = [jscene_mod.Instance(0, position=(dx, 0, dz))
                 for dx in (-2.2, 0.0, 2.2) for dz in (-2.2, 0.0, 2.2)]
    instances.append(jscene_mod.Instance(1))
    return [sphere, floor], instances


def _soup():
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (700, 1, 3))
    return (c + rng.uniform(-0.1, 0.1, (700, 3, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def bench_tris():
    models, instances = _bench_parts()
    return jscene_mod._bake_world(models, instances)["tri"]


def test_bench_scene_classic_bvh_identical(jax_native):
    """build_bench_scene(legacy_bvh=True): the classic BVH (native builder,
    16 triangles a leaf) and the depth equal the JAX package's scene build
    byte for byte; the dense tables stay those of the default build."""
    models, instances = _bench_parts()
    j, _, jdepth = jscene_mod.build_scene_instanced(models, instances, legacy_bvh=True,
                                                    flatten="auto")
    t, _, tdepth = build_bench_scene(legacy_bvh=True, device="cpu")
    _same_bvh(t.bvh, j.bvh)
    assert (t.bvh.n_nodes, t.bvh.n_prims) == (3197, 51168)
    assert tdepth == jdepth
    assert ttypes.LEAF_COUNT_BITS == jtypes.LEAF_COUNT_BITS
    assert tbuilder.bvh_depth(t.bvh) == jbuilder.bvh_depth(j.bvh) == 15 and tdepth == 17
    plain, _, _ = build_bench_scene(device="cpu")
    assert plain.bvh is None
    _same_bytes(plain.dense.nodes16, t.dense.nodes16, "nodes16")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("which", ["bench", "soup"])
def test_build_bvh_identical(which, native, bench_tris, request):
    """build_bvh: the native path vs the JAX default, the numpy path vs the
    JAX numpy path; woop_from_tris, bvh_depth and sah_cost alike."""
    if native:
        request.getfixturevalue("jax_native")
    tri = bench_tris if which == "bench" else _soup()
    t = tbuilder.build_bvh(tri, leaf_size=16, use_native=native)
    j = (jbuilder.build_bvh(tri, leaf_size=16) if native
         else jbuilder.build_bvh(tri, leaf_size=16, use_native=False))
    _same_bvh(t, j)
    assert t.nodes_box.device.type == "cpu"
    _same_bytes(ttypes.woop_from_tris(np.asarray(j.tris)), jtypes.woop_from_tris(j.tris),
                "woop")
    assert tbuilder.bvh_depth(t) == jbuilder.bvh_depth(j)
    nb, nc = np.asarray(j.nodes_box), np.asarray(j.nodes_child)
    assert ttypes.sah_cost(nb, nc) == jtypes.sah_cost(nb, nc)


def test_builders_differ_and_leaf_codes():
    """The numpy builder's tree is not the native one's (so the native path
    never falls back to it); leaf codes round-trip."""
    _needs_gxx()
    tri = _soup()
    a = tbuilder.build_bvh(tri, leaf_size=16)
    b = tbuilder.build_bvh(tri, leaf_size=16, use_native=False)
    assert a.nodes_box.shape != b.nodes_box.shape or not torch.equal(a.nodes_box, b.nodes_box)
    for first, count in ((0, 0), (16, 5), (51152, 16), (3, 127)):
        code = ttypes.encode_leaf(first, count)
        assert code == jtypes.encode_leaf(first, count) < 0
        assert ttypes.decode_leaf(code) == (first, count)


# ---------------------------------------------------------------------------
# kernel B4's plain version
# ---------------------------------------------------------------------------

def _leaf_inputs(seed=0):
    """tests/test_pallas.py's inputs: T=4 tiles of W=128 rays, L=3 leaf
    slots of K=16 over a 200-triangle soup's classic BVH."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (200, 1, 3))
    tri = (c + rng.uniform(-0.1, 0.1, (200, 3, 3))).astype(np.float32)
    bvh = jbuilder.build_bvh(tri, leaf_size=16)
    T, W, L = 4, 128, 3
    o = rng.uniform(-0.2, 1.2, (T, W, 3)).astype(np.float32)
    d = rng.normal(size=(T, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    child = np.asarray(bvh.nodes_child)
    leaf_codes = np.asarray([int(x) for x in child[child < 0]
                             if ((-(int(x) + 1)) & 127) > 0])
    lb = np.full((T, L), -1, np.int32)
    nl = np.zeros((T,), np.int32)
    for i in range(T):
        k = rng.integers(1, L + 1)
        lb[i, :k] = rng.choice(leaf_codes, size=k, replace=False)
        nl[i] = k
    return bvh, o, d, lb, nl


@pytest.mark.parametrize("tmax_scale", [None, 0.5])
def test_leaf_intersect_vs_pallas(tmax_scale):
    """B4's closest entry on the CPU (plain version) vs the Pallas kernel in
    interpret mode, from an empty state and from a state with hits and a
    finite tmax."""
    bvh, o, d, lb, nl = _leaf_inputs()
    T, W = o.shape[:2]
    t0 = np.full((T, W), 1e30, np.float32)
    u0 = np.zeros((T, W), np.float32)
    p0 = np.full((T, W), -1, np.int32)
    tmax = np.full((T, W), 1e30, np.float32)
    if tmax_scale is not None:   # a second pass over a state with hits
        first = leaf_intersect_pallas(*map(jnp.asarray, (o, d, tmax, t0, u0, u0, p0, lb, nl)),
                                      bvh.tris, leaf_size=16, interpret=True)
        t0, u0, v0, p0 = (np.asarray(x) for x in first)
        tmax = np.where(p0 >= 0, t0 * 1.5, 2.0).astype(np.float32)
        t0 = np.where(p0 >= 0, t0 * 1.2, 1e30).astype(np.float32)
        lb = np.roll(lb, 1, axis=0)
    want = leaf_intersect_pallas(*map(jnp.asarray, (o, d, tmax, t0, u0, u0, p0, lb, nl)),
                                 bvh.tris, leaf_size=16, interpret=True)
    wt, wu, wv, wp = (np.asarray(x) for x in want)
    state = [torch.from_numpy(np.array(x)) for x in (t0, u0, u0, p0)]
    _reset()
    got = leaf_mt.leaf_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tmax), *state, torch.from_numpy(lb),
                                 torch.from_numpy(nl), torch.from_numpy(np.asarray(bvh.tris)),
                                 leaf_size=16)
    assert leaf_mt.PLAIN_CALLS == {"closest": 1, "any": 0} and leaf_mt.LAUNCHES["closest"] == 0
    assert all(g is s for g, s in zip(got, state))          # updated in place
    gt, gu, gv, gp = (x.numpy() for x in got)
    np.testing.assert_array_equal(gp, wp)
    assert (gp >= 0).sum() >= 10     # random rays against a few small leaves
    hit = gp >= 0
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=T_RTOL)
    np.testing.assert_allclose(gu[hit], wu[hit], rtol=T_RTOL, atol=1e-6)
    np.testing.assert_allclose(gv[hit], wv[hit], rtol=T_RTOL, atol=1e-6)
    np.testing.assert_array_equal(gt[~hit], wt[~hit])


def _jax_dense_any(bvh, o, d, tmax, occ, lb, nl):
    """The JAX wave engine's any-mode dense phase (_wave_run)."""
    slots, col_ok = jtp._leaf_columns(jnp.asarray(lb), jnp.asarray(nl), 16)
    _, _, _, khit = jtp._mt_rows_dense(bvh, jnp.asarray(o), jnp.asarray(d), slots,
                                       col_ok, jnp.asarray(tmax))
    return np.asarray(jnp.asarray(occ) | jnp.any(khit & col_ok[:, None, :], axis=2))


@pytest.mark.parametrize("tmax_scale", [1.5, 0.5, 0.0])
def test_leaf_any_vs_jax(tmax_scale):
    """B4's any entry on the CPU vs the JAX any-mode dense phase, tmax beyond
    the closest hit, before it, and zero."""
    bvh, o, d, lb, nl = _leaf_inputs(seed=1)
    T, W = o.shape[:2]
    big = np.full((T, W), 1e30, np.float32)
    t, _, _, p = (np.asarray(x) for x in leaf_intersect_pallas(
        *map(jnp.asarray, (o, d, big, big, big * 0, big * 0,
                           np.full((T, W), -1, np.int32), lb, nl)),
        bvh.tris, leaf_size=16, interpret=True))
    tmax = np.where(p >= 0, t * tmax_scale, 3.0 * tmax_scale).astype(np.float32)
    occ0 = np.zeros((T, W), bool)
    occ0[:, ::7] = True                  # an occlusion carried from earlier waves
    want = _jax_dense_any(bvh, o, d, tmax, occ0, lb, nl)
    occ = torch.from_numpy(occ0.copy())
    _reset()
    got = leaf_mt.leaf_any(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
                           occ, torch.from_numpy(lb), torch.from_numpy(nl),
                           torch.from_numpy(np.asarray(bvh.tris)), leaf_size=16)
    assert got is occ and leaf_mt.PLAIN_CALLS == {"closest": 0, "any": 1}
    np.testing.assert_array_equal(got.numpy(), want)
    if tmax_scale == 1.5:
        assert (want & ~occ0).sum() >= 5
    if tmax_scale == 0.0:
        np.testing.assert_array_equal(want, occ0)


def test_leaf_wrapper_checks():
    """The wrappers refuse wrong dtypes, shapes, devices and leaf sizes."""
    bvh, o, d, lb, nl = _leaf_inputs()
    T, W = o.shape[:2]
    args = lambda: [torch.from_numpy(o), torch.from_numpy(d), torch.ones((T, W)),
                    torch.ones((T, W)), torch.zeros((T, W)), torch.zeros((T, W)),
                    torch.full((T, W), -1, dtype=torch.int32), torch.from_numpy(lb),
                    torch.from_numpy(nl), torch.from_numpy(np.asarray(bvh.tris))]
    a = args()
    a[6] = a[6].long()
    with pytest.raises(TypeError, match="prim"):
        leaf_mt.leaf_intersect(*a)
    a = args()
    a[2] = torch.ones((T, W + 1))
    with pytest.raises(ValueError, match="tmax"):
        leaf_mt.leaf_intersect(*a)
    a = args()
    a[9] = a[9].to("meta")
    with pytest.raises(ValueError, match="is on"):
        leaf_mt.leaf_intersect(*a)
    with pytest.raises(ValueError, match="leaf_size"):
        leaf_mt.leaf_intersect(*args(), leaf_size=0)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_leaf_count_work(mode):
    """B4's work for the bound, on leaf buffers counted by hand: tile 0
    holds leaves of 3 and 4 triangles, tile 1 none, tile 2 one leaf of 2
    that tile 0 holds too (and a code past nleaf, which is not live)."""
    enc = ttypes.encode_leaf
    lb = torch.tensor([[enc(0, 3), enc(10, 4), -1], [-1, -1, -1],
                       [enc(0, 2), enc(20, 4), -1]], dtype=torch.int32)
    nl = torch.tensor([2, 0, 1], dtype=torch.int32)
    W = 8
    w = leaf_mt.count_work(lb, nl, W, 4, mode)
    state = {"closest": 16, "any": 1}[mode]
    assert w["tri_tests"] == 9 * W and w["live_tiles"] == 2 and w["distinct_tris"] == 7
    assert w["bytes"] == 4 * 3 + 4 * 3 + 2 * W * (28 + 2 * state) + 36 * 7
    assert w["ops"] == {"f32": 9 * W * {"closest": 55, "any": 54}[mode]}


# ---------------------------------------------------------------------------
# the node scan's plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wave_scene():
    """The small instanced scene world-baked into one classic BVH, in both
    packages (the port's carried over from the JAX arrays)."""
    models, instances, lights, cam = instanced_parts()
    js, _, _ = jscene_mod.build_scene_instanced(models, instances, lights,
                                                legacy_bvh=True, flatten=False)
    ts = port_scene(js, bvh=True)
    v0 = np.asarray(js.tri_v0)
    tri = np.stack([v0, v0 + np.asarray(js.tri_e1), v0 + np.asarray(js.tri_e2)], 1)
    return js, ts, tri, cam


def test_scene_from_numpy_carries_bvh(wave_scene):
    js, ts, _, _ = wave_scene
    _same_bvh(ts.bvh, js.bvh)
    assert port_scene(js).bvh is None
    assert ts.to("cpu").bvh.n_nodes == ts.bvh.n_nodes


def _tiles(o, d, tmax, tile):
    """Both packages' padded tiles and wave state of these rays."""
    jo, jd, (jtm,), _, _ = jtp._pad_tiles(jnp.asarray(o), jnp.asarray(d),
                                          [jnp.asarray(tmax)], tile)
    to, td, (ttm,), _, _ = ttp._pad_tiles(torch.from_numpy(o), torch.from_numpy(d),
                                          [torch.from_numpy(tmax)], tile)
    return (jo, jd, jtm), (to, td, ttm)


@pytest.mark.parametrize("closest", [True, False])
def test_wave_scan_vs_jax(wave_scene, closest):
    """The scan's plain version (node_scan on CPU tensors) vs JAX's
    _wave_node_scan over the first waves of a wave run: cur, sp, stack,
    nleaf, leafbuf and active equal after every wave, and the tile bounds
    and pruning distances equal before the first."""
    js, ts, _, _ = wave_scene
    o, d = _rays(1000, seed=21)
    tmax = np.full((1000,), 1e30 if closest else 6.0, np.float32)
    (jo, jd, jtm), (to, td, ttm) = _tiles(o, d, tmax, TILE)
    jst = jtp._wave_state(js.bvh, jo, jd, jtm, 48, closest)
    tst = ttp._wave_state(to, td, ttm, 48, closest)
    for k in ("o_lo", "o_hi", "rd_lo", "rd_hi", "t_tile"):
        _same_bytes(tst[k], jst[k], k)
    scan = jax.jit(lambda st: jtp._wave_node_scan(js.bvh, st, 8, 4, None))
    _reset()
    leaves = 0
    for wave in range(12):
        want = scan(jst)
        got = wave_scan.node_scan(ts.bvh, tst, 8, 4)
        for name, g, w in zip(("cur", "sp", "stack", "nleaf", "leafbuf", "active"), got, want):
            _same_bytes(g, w, f"wave {wave}: {name}")
        leaves += int(got[3].sum())
        # the next wave starts from the JAX state in both packages
        jst = dict(jst, cur=want[0], sp=want[1], stack=want[2], active=want[5])
        for k, x in zip(("cur", "sp", "stack", "active"), (want[0], want[1], want[2], want[5])):
            tst[k] = torch.from_numpy(np.array(x))
    assert wave_scan.PLAIN_CALLS["scan"] == 12 and wave_scan.LAUNCHES["scan"] == 0
    assert leaves > 100 and wave_scan.truncated_pushes("cpu") == 0


def test_wave_scan_counts_overflow(wave_scene):
    """A push past the stack depth is counted, never a fault: a depth-1
    stack on this tree overflows."""
    _, ts, _, _ = wave_scene
    o, d = _rays(256, seed=22)
    to, td, (ttm,), _, _ = ttp._pad_tiles(torch.from_numpy(o), torch.from_numpy(d),
                                          [torch.full((256,), 1e30)], TILE)
    st = ttp._wave_state(to, td, ttm, 1, True)
    before = wave_scan.truncated_pushes("cpu")
    for _ in range(4):
        wave_scan.node_scan(ts.bvh, st, 8, 4)
    assert wave_scan.truncated_pushes("cpu") > before


@pytest.mark.parametrize("closest", [True, False])
def test_wave_scan_count_work(wave_scene, closest):
    """The scan's work for the bound over a few waves: it leaves the state,
    the plain-call count and the truncation count alone; the pushes kept
    less the pops are the stack pointers' growth; steps on a node are at
    most 8 per active tile; the bytes add up from the counts."""
    _, ts, _, _ = wave_scene
    o, d = _rays(1000, seed=23)
    tmax = np.full((1000,), 1e30 if closest else 6.0, np.float32)
    to, td, (ttm,), _, _ = ttp._pad_tiles(torch.from_numpy(o), torch.from_numpy(d),
                                          [torch.from_numpy(tmax)], TILE)
    st = ttp._wave_state(to, td, ttm, 48, closest)
    T = st["cur"].shape[0]
    _reset()
    trunc = wave_scan.truncated_pushes("cpu")
    pops = 0
    for wave in range(4):
        before = {k: st[k].clone() for k in wave_scan.STATE_KEYS}
        w = wave_scan.count_work(ts.bvh, st, 8, 4)
        for k, x in before.items():
            assert torch.equal(st[k], x), k
        wave_scan.node_scan(ts.bvh, st, 8, 4)
        assert w["pushes"] - w["pops"] == int((st["sp"] - before["sp"]).sum())
        assert w["active_tiles"] == int(before["active"].sum())
        assert 0 < w["tile_steps"] <= 8 * w["active_tiles"]
        assert 0 < w["distinct_nodes"] <= min(ts.bvh.n_nodes, w["tile_steps"])
        assert w["bytes"] == (T * (1 + 4 + 16) + 69 * w["active_tiles"]
                              + 4 * (w["pushes"] + w["pops"]) + 56 * w["distinct_nodes"])
        assert w["ops"] == {"f32": 171 * w["tile_steps"]}
        pops += w["pops"]
    assert pops > 0
    assert wave_scan.PLAIN_CALLS["scan"] == 4
    assert wave_scan.truncated_pushes("cpu") == trunc


# ---------------------------------------------------------------------------
# the wave traversal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_wave(wave_scene):
    """JAX results, jitted once per (mode, dense, sorted); cached."""
    js = wave_scene[0]
    cache = {}

    def get(closest, dense, sort, o, d, tmax):
        key = (closest, dense, sort, o.tobytes(), tmax.tobytes())
        if key not in cache:
            kw = dict(tile=TILE, dense=dense)
            fn = jtp.intersect_closest_wave if closest else jtp.intersect_any_wave
            if sort:
                wrap = jtp.sorted_closest if closest else jtp.sorted_any
                call = lambda o, d, t: wrap(fn, js.bvh, o, d, t, **kw)
            else:
                call = lambda o, d, t: fn(js.bvh, o, d, t, **kw)
            cache[key] = jax.tree.map(np.asarray, jax.jit(call)(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
        return cache[key]
    return get


def _port_wave(ts, closest, dense, sort, o, d, tmax):
    kw = dict(tile=TILE, dense=dense)
    fn = ttp.intersect_closest_wave if closest else ttp.intersect_any_wave
    args = (ts.bvh, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    if sort:
        wrap = ttp.sorted_closest if closest else ttp.sorted_any
        return wrap(fn, *args, **kw)
    return fn(*args, **kw)


@pytest.mark.parametrize("dense", ["mt", "woop"])
@pytest.mark.parametrize("sort", [False, True])
def test_closest_wave_vs_jax(wave_scene, jax_wave, dense, sort):
    """intersect_closest_wave (and sorted_closest around it) vs the JAX
    engine: found masks equal, t within 1e-6 relative, prim equal outside
    t-ties, inst 0 / -1; the cascade ran and only the plain versions ran."""
    _, ts, tri, _ = wave_scene
    o, d = _rays(N_RAYS, seed=23)
    tmax = np.full((N_RAYS,), 1e30, np.float32)
    want = jax_wave(True, dense, sort, o, d, tmax)
    _reset()
    got = _port_wave(ts, True, dense, sort, o, d, tmax)
    assert ttp.WAVES["closest"] > 0 and wave_scan.PLAIN_CALLS["scan"] == ttp.WAVES["closest"]
    assert leaf_mt.PLAIN_CALLS["closest"] == (ttp.WAVES["closest"] if dense == "mt" else 0)
    assert sum(leaf_mt.LAUNCHES.values()) + wave_scan.LAUNCHES["scan"] == 0
    gp, wp = got.prim.numpy(), want.prim
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    assert (gp >= 0).mean() > 0.3
    hit = gp >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], want.t[hit], rtol=T_RTOL)
    np.testing.assert_array_equal(got.t.numpy()[~hit], want.t[~hit])
    ties = _ties(tri, o, d)
    assert not ((gp != wp) & ~ties).any()
    np.testing.assert_array_equal(got.inst.numpy(), np.where(hit, 0, -1))
    assert got.t.dtype == torch.float32 and got.prim.dtype == torch.int32


@pytest.mark.parametrize("dense", ["mt", "woop"])
@pytest.mark.parametrize("sort", [False, True])
def test_any_wave_vs_jax(wave_scene, jax_wave, dense, sort):
    """intersect_any_wave (and sorted_any) vs the JAX engine with tmax
    beyond the closest hit on some rays, before it on others and zero on a
    fifth: occlusion exactly equal."""
    _, ts, _, _ = wave_scene
    o, d = _rays(N_RAYS, seed=24)
    gen = np.random.default_rng(5)
    near = jax_wave(True, "mt", False, o, d, np.full((N_RAYS,), 1e30, np.float32))
    scale = gen.choice([1.5, 0.5, 0.0], size=N_RAYS, p=[0.5, 0.3, 0.2])
    tmax = np.where(near.prim >= 0, near.t * scale, 9.0 * scale).astype(np.float32)
    want = jax_wave(False, dense, sort, o, d, tmax)
    _reset()
    got = _port_wave(ts, False, dense, sort, o, d, tmax).numpy()
    assert ttp.WAVES["any"] > 0
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.8 and not got[scale == 0.0].any()


def test_wave_wrapper_checks(wave_scene):
    _, ts, _, _ = wave_scene
    o, d = (torch.from_numpy(x) for x in _rays(64, seed=25))
    with pytest.raises(ValueError, match="classic BVH"):
        ttp.intersect_closest_wave(None, o, d)
    with pytest.raises(ValueError, match="t_max"):
        ttp.intersect_any_wave(ts.bvh, o, d, torch.ones(63))
    with pytest.raises(ValueError, match="dense"):
        ttp.intersect_closest_wave(ts.bvh, o, d, dense="fp8")
    hit = ttp.intersect_closest_wave(ts.bvh, o, d, tile=128)   # one partial tile
    assert hit.t.shape == (64,)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def test_renderer_wave_matches_jax(wave_scene):
    """Renderer(traversal="wave") at 16x16, 2 bounces, AA, one shadow ray:
    the port's first tick (plain versions on the CPU) vs the JAX Renderer's
    with the same key; only the wave engine ran."""
    js, ts, _, jcam = wave_scene
    want = JRenderer(js, jcam, WAVE_CFG).tick(jax.random.key(0))
    r = Renderer(ts, port_camera(jcam), port_config(WAVE_CFG), device="cpu")
    _reset()
    got = r.tick(0)
    assert leaf_mt.PLAIN_CALLS["closest"] > 0 and leaf_mt.PLAIN_CALLS["any"] > 0
    assert wave_scan.PLAIN_CALLS["scan"] == ttp.WAVES["closest"] + ttp.WAVES["any"]
    for m in (trace, trace_bf16, trace_rows):
        assert sum(m.PLAIN_CALLS.values()) == 0 and sum(m.LAUNCHES.values()) == 0
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    want = np.asarray(want)
    assert want.mean() > 1e-3
    _agree(got.reshape(-1, 3), want.reshape(-1, 3))


def test_check_supported_wave(wave_scene):
    """"wave" is carried with dense "mt" and "woop"; a traversal name the
    JAX package does not name is refused (the JAX package traces it with the
    lane engine), and so is "wave" on a scene without a classic BVH, before
    any device work (also with the default device, the card)."""
    js, ts, _, jcam = wave_scene
    cam = port_camera(jcam)
    cfg = port_config(WAVE_CFG)
    for dense in ("mt", "woop"):
        check_supported(cfg.replace(dense=dense), ts)
    with pytest.raises(NotImplementedError, match="dense"):
        check_supported(cfg.replace(dense="fp8"), ts)
    for traversal in ("bvh8", "Lane"):
        with pytest.raises(NotImplementedError, match="traversal"):
            check_supported(cfg.replace(traversal=traversal), ts)
    bare = dataclasses.replace(ts, bvh=None)
    with pytest.raises(NotImplementedError, match="classic BVH"):
        check_supported(cfg, bare)
    for device in ({}, {"device": "cpu"}):
        with pytest.raises(NotImplementedError, match="classic BVH"):
            Renderer(bare, cam, cfg, **device)
    plain_scene, _ = instanced_scene()       # legacy_bvh=False: no classic BVH
    with pytest.raises(NotImplementedError, match="classic BVH"):
        check_supported(cfg, port_scene(plain_scene))


@pytest.mark.cuda
def test_wave_kernels_vs_plain_on_gpu(wave_scene):
    """The engine's path on the card, the fused level (``ops/wave_level.py``,
    one wave a launch), against the plain wave over the waves of a level,
    and the scan kernel and B4 against their plain versions on each wave's
    inputs; then the engine on the card vs on the CPU (runs where a GPU is
    present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from physically_based_ray_tracer_tpu_torch.ops import wave_level
    dev = torch.device("cuda")
    _, ts, _, _ = wave_scene
    bvh = ts.bvh.to(dev)
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(N_RAYS, seed=26))
    for closest in (True, False):
        tmax = torch.full((N_RAYS,), 1e30 if closest else 6.0, device=dev)
        to, td, (ttm,), _, _ = ttp._pad_tiles(o, d, [tmax], 128)
        st = ttp._wave_state(to, td, ttm, 48, closest)
        keys = ("t", "u", "v", "prim") if closest else ("occ",)
        while bool(st["active"].any()):
            before = {k: v.clone() for k, v in st.items()}
            want = wave_level.plain_run_level(bvh, before, closest=closest, node_steps=8,
                                              leaf_cap=4, leaf_size=16, min_active=0,
                                              max_waves=1)
            wave_level.run_level(bvh, st, closest=closest, node_steps=8, leaf_cap=4,
                                 leaf_size=16, min_active=0, max_waves=1)
            for k in wave_level.LEVEL_KEYS["closest" if closest else "any"]:
                assert torch.equal(st[k], want[k]), k
            scan_in = {k: v.clone() for k, v in before.items()}
            got = wave_scan.node_scan(bvh, scan_in, 8, 4)
            for a, b in zip(got, wave_scan.plain_node_scan(bvh, before, 8, 4)):
                assert torch.equal(a, b)
            state0 = [before[k].clone() for k in keys]
            rays = (before["o_t"], before["d_t"], before["tmax"])
            if closest:
                leaf_mt.leaf_intersect(*rays, *(before[k] for k in keys), got[4], got[3],
                                       bvh.tris)
                ref = leaf_mt.plain_leaf_intersect(*rays, *state0, got[4], got[3], bvh.tris, 16)
            else:
                leaf_mt.leaf_any(*rays, before["occ"], got[4], got[3], bvh.tris)
                ref = (leaf_mt.plain_leaf_any(*rays, *state0, got[4], got[3], bvh.tris, 16),)
            for k, w in zip(keys, ref):
                assert torch.equal(before[k], w), k
        wrap = ttp.sorted_closest if closest else ttp.sorted_any
        fn = ttp.intersect_closest_wave if closest else ttp.intersect_any_wave
        gpu = wrap(fn, bvh, o, d, tmax)
        cpu = wrap(fn, ts.bvh, o.cpu(), d.cpu(), tmax.cpu())
        for a, b in zip(gpu if closest else [gpu], cpu if closest else [cpu]):
            assert torch.equal(a.cpu(), b)
    assert wave_scan.truncated_pushes(dev) == 0
