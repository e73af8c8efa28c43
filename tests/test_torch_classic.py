"""The classic-BVH torch engines of the port (``traversal="lane"``,
``ops/traverse.py``, and ``traversal="packet"``, ``ops/traverse_packet.py``)
vs the JAX package's XLA engines on the CPU, the three ``morton_key`` modes,
``tests/test_bvh.py``'s brute-force checks replayed on the port, and the
slice (``Renderer``) vs the JAX ``Renderer``.

Tolerances: t within 1e-6 relative (XLA:CPU may contract the multiply-adds
of Möller-Trumbore that PyTorch keeps apart); prim equal except where a
float64 brute force sees a t-tie; found masks, occlusion and miss records
exactly equal; sort keys bit for bit; images as
tests/test_torch_render.py::_agree. Each JAX function is jitted once per
module and argument set (module-scoped cache)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh import builder as jbuilder  # noqa: E402
from physically_based_ray_tracer_tpu.ops import traverse as jtraverse  # noqa: E402
from physically_based_ray_tracer_tpu.ops import traverse_packet as jtp  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import builder as tbuilder  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import (leaf_mt, trace, trace_bf16,  # noqa: E402
                                                       trace_rows, traverse, wave_scan)
from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as ttp  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.intersect import brute_force_intersect  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from tests.scenes import TINY, sphere_scene  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.test_torch_trace import _rays, _ties  # noqa: E402
from tests.test_torch_wave import _needs_gxx  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

T_RTOL = 1e-6
N_RAYS = 1024


def _random_tris(gen, n, spread=0.05):
    c = gen.uniform(0, 1, (n, 1, 3))
    return (c + gen.uniform(-spread, spread, (n, 3, 3))).astype(np.float32)


def _random_rays(gen, b):
    o = gen.uniform(-0.2, 1.2, (b, 3)).astype(np.float32)
    d = gen.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _sphere_tris():
    """A 768-triangle sphere over a floor."""
    sph = make_sphere(radius=1.0, lat=16, lon=24)[0].reshape(-1, 3, 3)
    quad = make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    return np.concatenate([sph, quad.reshape(-1, 3, 3)]).astype(np.float32)


def _scene(which):
    """(triangles, o, d) of a scene seen from outside: the sphere, or
    clustered geometry (256 well-shaped triangles whose centroids lie within
    1e-6 of one point: median splits), tilted at most 25 degrees from the xy
    plane, under rays from above. Origins outside keep t away from 0, and
    the cluster's hits are neither grazing nor on slivers: there float32
    Möller-Trumbore's error in t, which differs between XLA's contracted
    multiply-adds and PyTorch's, grows past T_RTOL."""
    if which == "sphere":
        o, d = _rays(N_RAYS, seed=31)
        return _sphere_tris(), o, d
    gen = np.random.default_rng(11)
    # equilateral triangles of circumradius 0.15-0.3, spun about z, tilted
    # up to 25 degrees about a random horizontal axis
    ang = gen.uniform(0, 2 * np.pi, (256, 1)) + np.float64([0, 2, 4]) * np.pi / 3
    r = gen.uniform(0.15, 0.3, (256, 1))
    off = np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros_like(ang)], -1)
    axis = gen.uniform(0, 2 * np.pi, 256)
    tilt = gen.uniform(0, np.radians(25), 256)
    ax, ay = np.cos(axis), np.sin(axis)
    c, s_ = np.cos(tilt), np.sin(tilt)
    rot = np.stack([np.stack([c + ax * ax * (1 - c), ax * ay * (1 - c), ay * s_], -1),
                    np.stack([ax * ay * (1 - c), c + ay * ay * (1 - c), -ax * s_], -1),
                    np.stack([-ay * s_, ax * s_, c], -1)], 1)          # Rodrigues
    off = np.einsum("nij,nkj->nki", rot, off)
    tri = (0.5 + off + gen.uniform(-1e-6, 1e-6, (256, 1, 3))).astype(np.float32)
    o = np.concatenate([gen.uniform(0.0, 1.0, (N_RAYS, 2)), np.full((N_RAYS, 1), 2.5)], 1)
    d = 0.5 + gen.normal(scale=0.15, size=(N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, o.astype(np.float32), d.astype(np.float32)


def _tmax(kind, tri, o, d):
    """None, or the brute-force t scaled past (1.5) and before (0.5) the hit,
    and 0 on a fifth of the lanes."""
    if kind is None:
        return None
    v0 = tri[:, 0]
    ref = brute_force_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(v0), torch.from_numpy(tri[:, 1] - v0),
                                torch.from_numpy(tri[:, 2] - v0))
    gen = np.random.default_rng(5)
    scale = gen.choice([1.5, 0.5, 0.0], size=o.shape[0], p=[0.5, 0.3, 0.2])
    hit = ref.prim.numpy() >= 0
    return np.where(hit, ref.t.numpy() * scale, 9.0 * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engines' results, jitted once per argument set; cached."""
    cache = {}

    def get(engine, closest, bvh_np, o, d, tmax, **kw):
        key = (engine, closest, tuple(a.tobytes() for a in bvh_np), o.tobytes(),
               None if tmax is None else tmax.tobytes(), tuple(sorted(kw.items())))
        if key not in cache:
            bvh = jbuilder.BVHArrays.from_numpy(*bvh_np).to_device()
            if engine == "lane":
                fn = jtraverse.intersect_closest if closest else jtraverse.intersect_any
            else:
                fn = jtp.intersect_closest_packet if closest else jtp.intersect_any_packet
            if tmax is None:
                call = lambda o, d: fn(bvh, o, d, **kw)
                out = jax.jit(call)(jnp.asarray(o), jnp.asarray(d))
            else:
                call = lambda o, d, t: fn(bvh, o, d, t, **kw)
                out = jax.jit(call)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
            cache[key] = jax.tree.map(np.asarray, out)
        return cache[key]
    return get


def _bvh_pair(tri, leaf_size):
    """The native classic BVH of ``tri`` in both packages' types."""
    _needs_gxx()
    t = tbuilder.build_bvh(tri, leaf_size=leaf_size)
    arrays = tuple(getattr(t, f).numpy() for f in ("nodes_box", "nodes_child", "tris",
                                                   "prim_index"))
    return t, arrays


def _port_engine(engine, closest, bvh, o, d, tmax, **kw):
    fn = {("lane", True): traverse.intersect_closest, ("lane", False): traverse.intersect_any,
          ("packet", True): ttp.intersect_closest_packet,
          ("packet", False): ttp.intersect_any_packet}[(engine, closest)]
    args = [bvh, torch.from_numpy(o), torch.from_numpy(d)]
    if tmax is not None:
        args.append(torch.from_numpy(tmax))
    return fn(*args, **kw)


def _check_hits(got, want, ties):
    """t within T_RTOL on hits, prim equal outside ties, and the miss
    records (t, u, v, prim, inst) field for field."""
    gp, wp = got.prim.numpy(), want.prim
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    hit = wp >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], want.t[hit], rtol=T_RTOL)
    assert not ((gp != wp) & ~ties).any(), f"{((gp != wp) & ~ties).sum()} prims differ"
    same = hit & (gp == wp)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same], getattr(want, f)[same],
                                   rtol=1e-5, atol=1e-5)
    for f in ("t", "u", "v", "prim", "inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[~hit], getattr(want, f)[~hit],
                                      err_msg=f"miss record: {f}")
    np.testing.assert_array_equal(got.inst.numpy(), np.where(hit, 0, -1))
    assert got.t.dtype == torch.float32 and got.prim.dtype == torch.int32
    assert got.inst.dtype == torch.int32


# ---------------------------------------------------------------------------
# the engines vs JAX
# ---------------------------------------------------------------------------

ENGINE_CASES = [("lane", "sphere", 4, 64), ("lane", "sphere", 16, 64),
                ("lane", "clustered", 4, 64), ("lane", "clustered", 16, 64),
                ("packet", "sphere", 4, 64), ("packet", "sphere", 16, 128),
                ("packet", "clustered", 4, 128), ("packet", "clustered", 16, 64)]


@pytest.mark.parametrize("engine,which,leaf_size,tile", ENGINE_CASES)
@pytest.mark.parametrize("tmax_kind", [None, "mixed"])
def test_closest_vs_jax(jax_engine, engine, which, leaf_size, tile, tmax_kind):
    """Closest hit, with t_max None and with t_max past the hit, before it and
    0 on some lanes: t, prim, found and the miss records as the JAX
    engine's (each engine its own miss record)."""
    tri, o, d = _scene(which)
    bvh, arrays = _bvh_pair(tri, leaf_size)
    tmax = _tmax(tmax_kind, tri, o, d)
    kw = dict(stack_depth=48, leaf_size=leaf_size)
    if engine == "packet":
        kw["tile"] = tile
    want = jax_engine(engine, True, arrays, o, d, tmax, **kw)
    traverse.reset_counts()
    ttp.reset_counts()
    got = _port_engine(engine, True, bvh, o, d, tmax, **kw)
    steps = traverse.STEPS if engine == "lane" else ttp.PACKET_STEPS
    assert steps["closest"] > 0 and steps["any"] == 0
    _check_hits(got, want, _ties(tri, o, d))
    assert (want.prim >= 0).sum() >= 50
    if tmax is not None:
        assert not (got.prim.numpy() >= 0)[tmax == 0.0].any()


@pytest.mark.parametrize("engine,which,leaf_size,tile", ENGINE_CASES)
def test_any_vs_jax(jax_engine, engine, which, leaf_size, tile):
    """Occlusion with t_max past the closest hit, before it and 0: exactly
    the JAX engine's."""
    tri, o, d = _scene(which)
    bvh, arrays = _bvh_pair(tri, leaf_size)
    tmax = _tmax("mixed", tri, o, d)
    kw = dict(stack_depth=48, leaf_size=leaf_size)
    if engine == "packet":
        kw["tile"] = tile
    want = jax_engine(engine, False, arrays, o, d, tmax, **kw)
    got = _port_engine(engine, False, bvh, o, d, tmax, **kw)
    assert got.dtype == torch.bool and got.shape == (N_RAYS,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9 and not want[tmax == 0.0].any()


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_miss_records(jax_engine, engine):
    """Hazard of the two engines' miss records: the lane engine leaves t at
    t_max (BVH_FAR without one) with u = v = 0; the packet engine gives
    BVH_FAR whatever t_max is; prim and inst are -1 in both. Rays that miss
    everything, field for field against JAX."""
    tri = _sphere_tris()
    o = np.tile(np.float32([[0.0, 5.0, 0.0]]), (256, 1))
    d = np.tile(np.float32([[0.0, 1.0, 0.0]]), (256, 1))            # straight up
    bvh, arrays = _bvh_pair(tri, 4)
    kw = dict(stack_depth=48, leaf_size=4)
    if engine == "packet":
        kw["tile"] = 64
    tmax = np.linspace(0.0, 50.0, 256).astype(np.float32)
    for tm in (None, tmax):
        want = jax_engine(engine, True, arrays, o, d, tm, **kw)
        got = _port_engine(engine, True, bvh, o, d, tm, **kw)
        for f in ("t", "u", "v", "prim", "inst"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
        far = np.full((256,), 1e30, np.float32)
        expect_t = tm if (engine == "lane" and tm is not None) else far
        np.testing.assert_array_equal(got.t.numpy(), expect_t)
        assert (got.prim.numpy() == -1).all() and (got.u.numpy() == 0).all()


@pytest.mark.parametrize("stack_depth", [1, 2, 4])
@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_stack_overflow_matches_jax(jax_engine, engine, stack_depth):
    """A stack too shallow for the tree (depth 9): pushes onto the full stack
    are lost, and a pop past the end reads INT32_MIN, a leaf at the clamped
    last triangle row, as in JAX. The port gives JAX's answers (not brute
    force's), closest and any, and counts the overflow pushes."""
    tri = make_sphere(radius=1.0, lat=16, lon=24)[0].reshape(-1, 3, 3).astype(np.float32)
    o, d = _rays(512, seed=32, radius=3.0)
    bvh, arrays = _bvh_pair(tri, 4)
    assert tbuilder.bvh_depth(bvh) == 9
    kw = dict(stack_depth=stack_depth, leaf_size=4)
    if engine == "packet":
        kw["tile"] = 64
    before = traverse.overflow_pushes("cpu")
    want = jax_engine(engine, True, arrays, o, d, None, **kw)
    got = _port_engine(engine, True, bvh, o, d, None, **kw)
    ties = _ties(tri, o, d)
    _check_hits(got, want, ties)
    assert traverse.overflow_pushes("cpu") > before
    if stack_depth == 1:
        v0 = tri[:, 0]
        brute = brute_force_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(v0), torch.from_numpy(tri[:, 1] - v0),
                                      torch.from_numpy(tri[:, 2] - v0))
        assert ((got.prim != brute.prim).numpy() & ~ties).sum() > 10
    far = np.full((512,), 1e30, np.float32)
    want_occ = jax_engine(engine, False, arrays, o, d, far, **kw)
    got_occ = _port_engine(engine, False, bvh, o, d, far, **kw)
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_check_every_is_bit_equal(monkeypatch, engine):
    """Reading the loop test every CHECK_EVERY steps and compacting the
    working rows to the active ones gives, bit for bit, what the literal
    loop gives (the test read every step, every row stepped to the end): a
    finished lane or tile is a fixed point of the step, and rows are
    independent."""
    assert traverse.CHECK_EVERY > 1 and traverse.COMPACT_BELOW > 0
    tri, o, d = _scene("sphere")
    bvh, _ = _bvh_pair(tri, 16)
    tmax = _tmax("mixed", tri, o, d)
    kw = dict(stack_depth=48, leaf_size=16)
    if engine == "packet":
        kw["tile"] = 64
    runs = []
    for n, share in ((traverse.CHECK_EVERY, traverse.COMPACT_BELOW), (1, 0.0)):
        monkeypatch.setattr(traverse, "CHECK_EVERY", n)
        monkeypatch.setattr(traverse, "COMPACT_BELOW", share)
        hit = _port_engine(engine, True, bvh, o, d, None, **kw)
        occ = _port_engine(engine, False, bvh, o, d, tmax, **kw)
        runs.append([x.numpy() for x in hit] + [occ.numpy()])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_compaction_is_exact(monkeypatch, engine):
    """Rays that leave the scene finish within a few steps while the others
    traverse on: the working rows compact to the active ones (counted), and
    every result equals the uncompacted loop's bit for bit."""
    tri, o, d = _scene("sphere")
    o, d = o.copy(), d.copy()
    o[N_RAYS // 2:] = (0.0, 20.0, 0.0)         # above the scene, looking up
    d[N_RAYS // 2:] = (0.0, 1.0, 0.0)
    bvh, _ = _bvh_pair(tri, 16)
    tmax = _tmax("mixed", tri, o, d)
    kw = dict(stack_depth=48, leaf_size=16)
    if engine == "packet":
        kw["tile"] = 16
    nonzero = torch.nonzero
    sizes = []
    monkeypatch.setattr(torch, "nonzero", lambda x, *a, **k: (sizes.append(x.numel()),
                                                              nonzero(x, *a, **k))[1])
    runs = []
    for share in (traverse.COMPACT_BELOW, 0.0):
        monkeypatch.setattr(traverse, "COMPACT_BELOW", share)
        hit = _port_engine(engine, True, bvh, o, d, None, **kw)
        occ = _port_engine(engine, False, bvh, o, d, tmax, **kw)
        runs.append([x.numpy() for x in hit] + [occ.numpy()])
        if share:
            assert len(sizes) >= 2, sizes       # both calls compacted
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (runs[0][3] >= 0).sum() > 100


@pytest.mark.parametrize("which", ["sphere", "clustered"])
def test_lane_and_packet_bit_equal(which):
    """The two engines run the same Möller-Trumbore operations, so where both
    find a hit their t is bit-equal (prims may differ on exact ties only);
    found masks and occlusion are equal."""
    tri, o, d = _scene(which)
    bvh, _ = _bvh_pair(tri, 16)
    kw = dict(stack_depth=48, leaf_size=16)
    lane = _port_engine("lane", True, bvh, o, d, None, **kw)
    packet = ttp.sorted_closest(ttp.intersect_closest_packet, bvh, torch.from_numpy(o),
                                torch.from_numpy(d), tile=128, **kw)
    found = lane.prim >= 0
    assert torch.equal(found, packet.prim >= 0) and found.sum() > 100
    assert torch.equal(lane.t[found], packet.t[found])
    assert not ((lane.prim != packet.prim).numpy() & ~_ties(tri, o, d)).any()
    tmax = torch.from_numpy(_tmax("mixed", tri, o, d))
    occ_l = traverse.intersect_any(bvh, torch.from_numpy(o), torch.from_numpy(d), tmax, **kw)
    occ_p = ttp.sorted_any(ttp.intersect_any_packet, bvh, torch.from_numpy(o),
                           torch.from_numpy(d), tmax, tile=128, **kw)
    assert torch.equal(occ_l, occ_p)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_cuda_graph_blocks_on_gpu(monkeypatch, engine):
    """On the card the step blocks run as CUDA graphs; they give, bit for
    bit, what the steps run op by op give, and what the CPU gives (runs
    where a GPU is present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tri, o, d = _scene("sphere")
    bvh, _ = _bvh_pair(tri, 16)
    tmax = _tmax("mixed", tri, o, d)
    kw = dict(stack_depth=48, leaf_size=16)
    if engine == "packet":
        kw["tile"] = 64
    runs = []
    for dev, graphs in (("cuda", True), ("cuda", False), ("cpu", False)):
        monkeypatch.setattr(traverse, "CUDA_GRAPHS", graphs)
        b = bvh.to(dev)
        fn = {"lane": (traverse.intersect_closest, traverse.intersect_any),
              "packet": (ttp.intersect_closest_packet, ttp.intersect_any_packet)}[engine]
        args = [torch.from_numpy(x).to(dev) for x in (o, d)]
        hit = fn[0](b, *args, **kw)
        occ = fn[1](b, *args, torch.from_numpy(tmax).to(dev), **kw)
        runs.append([x.cpu() for x in hit] + [occ.cpu()])
    for a, b, _ in zip(*runs):
        assert torch.equal(a, b), "CUDA graphs vs op by op"
    # the card vs the CPU: the same found masks and occlusion, t to T_RTOL
    assert torch.equal(runs[0][3] >= 0, runs[2][3] >= 0)
    assert torch.equal(runs[0][5], runs[2][5])
    torch.testing.assert_close(runs[0][0], runs[2][0], rtol=T_RTOL, atol=0)


def test_wrapper_checks():
    tri, o, d = _scene("sphere")
    bvh, _ = _bvh_pair(tri, 4)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    with pytest.raises(ValueError, match="classic BVH"):
        traverse.intersect_closest(None, o, d)
    with pytest.raises(ValueError, match="t_max"):
        ttp.intersect_any_packet(bvh, o, d, torch.ones(3))
    with pytest.raises(ValueError, match="float32"):
        traverse.intersect_any(bvh, o.double(), d, torch.ones(N_RAYS))
    hit = ttp.intersect_closest_packet(bvh, o[:50], d[:50], tile=64)   # one partial tile
    assert hit.t.shape == (50,)


# ---------------------------------------------------------------------------
# morton_key's three modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["octant_major", "morton_major", "six_d"])
def test_morton_key_modes_bit_equal(mode):
    """Keys bit for bit against the JAX package's in every mode, with and
    without dead lanes; morton_order the same stable permutation."""
    gen = np.random.default_rng(3)
    o = gen.uniform(-3, 3, (4096, 3)).astype(np.float32)
    o[:64] = gen.uniform(-9, 9, (64, 3))                     # outside the box: clamped
    d = gen.normal(size=(4096, 3)).astype(np.float32)
    d[64:128, 1] = 0.0                                       # direction components at 0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = np.float32([-2, -1, -2]), np.float32([2, 2.5, 2])
    dead = gen.uniform(0, 1, 4096) < 0.2
    for dd in (None, dead):
        want = np.asarray(jtp.morton_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                         jnp.asarray(hi), None if dd is None
                                         else jnp.asarray(dd), mode=mode))
        got = trace.morton_key(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
                               torch.from_numpy(hi), None if dd is None
                               else torch.from_numpy(dd), mode=mode)
        assert got.dtype == torch.int64 and (got >= 0).all() and (got < 2**32).all()
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        perm = ttp.morton_order(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
                                torch.from_numpy(hi), None if dd is None
                                else torch.from_numpy(dd), mode=mode)
        want_perm = jtp.morton_order(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                     jnp.asarray(hi), None if dd is None else jnp.asarray(dd),
                                     mode=mode)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    assert len(np.unique(want)) > 100
    with pytest.raises(ValueError, match="mode"):
        trace.morton_key(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
                         torch.from_numpy(hi), mode="z_order")


# ---------------------------------------------------------------------------
# tests/test_bvh.py's brute-force checks on the port
# ---------------------------------------------------------------------------

def _oracle(tri, o, d):
    v0 = tri[:, 0]
    return brute_force_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(v0), torch.from_numpy(tri[:, 1] - v0),
                                 torch.from_numpy(tri[:, 2] - v0))


@pytest.mark.parametrize("engine", ["lane", "packet"])
@pytest.mark.parametrize("n_tris", [1, 3, 4, 5, 37, 500])
def test_closest_hit_matches_brute_force(n_tris, engine):
    _needs_gxx()
    gen = np.random.default_rng(n_tris)
    tri = _random_tris(gen, n_tris)
    bvh = tbuilder.build_bvh(tri)
    o, d = _random_rays(gen, 128)
    hit = _port_engine(engine, True, bvh, o, d, None, leaf_size=4)
    ref = _oracle(tri, o, d)
    np.testing.assert_array_equal(hit.prim.numpy(), ref.prim.numpy())
    np.testing.assert_allclose(hit.t.numpy(), ref.t.numpy(), rtol=1e-4, atol=1e-5)
    m = hit.prim.numpy() >= 0
    np.testing.assert_allclose(hit.u.numpy()[m], ref.u.numpy()[m], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[m], ref.v.numpy()[m], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_any_hit_matches_closest_validity(engine):
    _needs_gxx()
    gen = np.random.default_rng(7)
    tri = _random_tris(gen, 200)
    bvh = tbuilder.build_bvh(tri)
    o, d = _random_rays(gen, 128)
    hit = _port_engine(engine, True, bvh, o, d, None, leaf_size=4)
    occ = _port_engine(engine, False, bvh, o, d, np.full((128,), 1e30, np.float32),
                       leaf_size=4)
    np.testing.assert_array_equal(occ.numpy(), hit.prim.numpy() >= 0)


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_any_hit_respects_tmax_and_clips_closest(engine):
    """One triangle at z=1, rays from the origin along +z."""
    _needs_gxx()
    tri = np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    bvh = tbuilder.build_bvh(tri)
    o = np.zeros((2, 3), np.float32)
    d = np.tile(np.float32([0, 0, 1]), (2, 1))
    occ = _port_engine(engine, False, bvh, o, d, np.float32([0.5, 2.0]), leaf_size=4)
    assert occ.tolist() == [False, True]
    near = _port_engine(engine, True, bvh, o[:1], d[:1], np.float32([0.5]), leaf_size=4)
    assert int(near.prim[0]) == -1


def test_depth_within_stack_bound():
    _needs_gxx()
    bvh = tbuilder.build_bvh(_random_tris(np.random.default_rng(3), 2000))
    assert tbuilder.bvh_depth(bvh) < 48


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_clustered_geometry(engine):
    """Nearly identical centroids force median splits."""
    _needs_gxx()
    gen = np.random.default_rng(11)
    tri = _random_tris(gen, 64, spread=1e-7) + np.float32(0.5)
    bvh = tbuilder.build_bvh(tri)
    o, d = _random_rays(gen, 64)
    hit = _port_engine(engine, True, bvh, o, d, None, leaf_size=4)
    np.testing.assert_allclose(hit.t.numpy(), _oracle(tri, o, d).t.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scene():
    """tests/test_integrator.py's sphere scene (classic BVH built) in both
    packages."""
    _needs_gxx()
    js, jcam = sphere_scene()
    return js, port_scene(js, bvh=True), jcam


def _tiny_render(ts, jcam, traversal):
    r = Renderer(ts, port_camera(jcam), port_config(TINY.replace(traversal=traversal)),
                 device="cpu")
    return r.tick(0)


def test_check_supported_classic_engines(tiny_scene):
    """"lane" and "packet" are carried on a scene with a classic BVH and
    refused, before any device work, on a scene without one; a name the
    JAX package does not name stays refused."""
    import dataclasses

    from physically_based_ray_tracer_tpu_torch.render.integrator import check_supported
    _, ts, jcam = tiny_scene
    cfg = port_config(TINY)
    bare = dataclasses.replace(ts, bvh=None)
    for engine in ("lane", "packet"):
        check_supported(cfg.replace(traversal=engine), ts)
        with pytest.raises(NotImplementedError, match="classic BVH"):
            check_supported(cfg.replace(traversal=engine), bare)
        with pytest.raises(NotImplementedError, match="classic BVH"):
            Renderer(bare, port_camera(jcam), cfg.replace(traversal=engine))
    with pytest.raises(NotImplementedError, match="traversal"):
        check_supported(cfg.replace(traversal="lanes"), ts)


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_renderer_matches_jax(tiny_scene, engine):
    """Renderer(traversal=engine) at TINY (32x32, 2 bounces, packet_tile 64,
    stack depth 24): the port's first tick vs the JAX Renderer's with the
    same key; only the engine's loop ran, no kernel and no plain version."""
    js, ts, jcam = tiny_scene
    want = np.asarray(JRenderer(js, jcam, TINY.replace(traversal=engine)).tick(
        jax.random.key(0)))
    for m in (trace, trace_bf16, trace_rows, leaf_mt, wave_scan, traverse, ttp):
        m.reset_counts()
    got = _tiny_render(ts, jcam, engine)
    steps = traverse.STEPS if engine == "lane" else ttp.PACKET_STEPS
    assert steps["closest"] > 0 and steps["any"] > 0
    other = ttp.PACKET_STEPS if engine == "lane" else traverse.STEPS
    assert sum(other.values()) == 0 and ttp.WAVES == {"closest": 0, "any": 0}
    for m in (trace, trace_bf16, trace_rows, leaf_mt, wave_scan):
        assert sum(m.PLAIN_CALLS.values()) == 0 and sum(m.LAUNCHES.values()) == 0
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    assert want.mean() > 1e-3
    _agree(got.reshape(-1, 3), want.reshape(-1, 3))


def test_traversal_mode_equivalence(tiny_scene):
    """tests/test_integrator.py's check on the port: wave, packet and lane
    render the same image."""
    _, ts, jcam = tiny_scene
    imgs = {m: _tiny_render(ts, jcam, m) for m in ("wave", "packet", "lane")}
    np.testing.assert_allclose(imgs["wave"], imgs["packet"], atol=1e-5)
    np.testing.assert_allclose(imgs["wave"], imgs["lane"], atol=1e-5)


@pytest.mark.parametrize("engine", ["lane", "packet"])
def test_classic_engines_are_detached(tiny_scene, monkeypatch, engine):
    """The engine functions see o, d and t_max with no autograd history while
    the camera carries one; the gradient still reaches the camera through
    refine_hit and shading."""
    from physically_based_ray_tracer_tpu_torch.diff.grad import (apply_params, clone_params,
                                                                 render_color)
    _, ts, jcam = tiny_scene
    module, names = ((traverse, ("intersect_closest", "intersect_any")) if engine == "lane"
                     else (ttp, ("intersect_closest_packet", "intersect_any_packet")))
    seen = []

    def spy(fn):
        def wrapped(bvh, o, d, t_max=None, *a, **kw):
            seen.append(any(x is not None and x.requires_grad for x in (o, d, t_max)))
            return fn(bvh, o, d, t_max, *a, **kw)
        return wrapped

    for name in names:
        monkeypatch.setattr(module, name, spy(getattr(module, name)))
    cfg = port_config(TINY.replace(traversal=engine, width=8, height=8))
    cam = port_camera(jcam)
    params = clone_params({"camera_pos": cam.pos, "base_color": ts.mat_base})
    s, c = apply_params(ts, cam, params)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    torch.mean(render_color(s, c, cfg, 0, 0, ids) ** 2).backward()
    assert len(seen) >= 3 and not any(seen), seen
    for k, v in params.items():
        assert v.grad is not None and torch.isfinite(v.grad).all() and v.grad.abs().max() > 0, k


def test_bvh_arrays_round_trip():
    """BVHArrays carried over from numpy keep the builder's bytes (the JAX
    comparisons above feed the JAX engines the port's tables)."""
    _needs_gxx()
    tri = _sphere_tris()
    t = tbuilder.build_bvh(tri, leaf_size=4)
    j = jbuilder.build_bvh(tri, leaf_size=4)
    for f in ("nodes_box", "nodes_child", "tris", "prim_index"):
        assert getattr(t, f).numpy().tobytes() == np.asarray(getattr(j, f)).tobytes(), f
    back = BVHArrays.from_numpy(*(getattr(t, f).numpy() for f in (
        "nodes_box", "nodes_child", "tris", "prim_index")), device="cpu")
    assert torch.equal(back.tris_woop, t.tris_woop)
