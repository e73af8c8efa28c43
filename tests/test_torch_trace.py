"""Port traversal (its plain version, as the CPU runs it) vs the JAX package's
Pallas kernel in interpret mode and its brute-force oracle, on one- and
two-level tables.

Tolerances: t within rtol=1e-5 (both compute Möller-Trumbore in float32;
XLA may contract multiply-adds that PyTorch's CPU kernels keep apart); prim
equal except where the reference sees a t-tie (two triangles within 1e-5
relative, e.g. a ray through a shared edge, where either answer is right);
occlusion exactly equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh.dense import build_dense  # noqa: E402
from physically_based_ray_tracer_tpu.ops import pallas_trace as jtrace  # noqa: E402
from physically_based_ray_tracer_tpu.ops.intersect import brute_force_intersect as jbrute  # noqa: E402
from physically_based_ray_tracer_tpu.ops.traverse_packet import morton_key as jmorton  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.dense import DenseBVH  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace as ttrace  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.intersect import brute_force_intersect as tbrute  # noqa: E402
from tests.torch_port import instanced_scene  # noqa: E402

RTOL = 1e-5


def _one_level():
    sph = make_sphere(radius=1.0, lat=12, lon=18)[0].reshape(-1, 3, 3)
    quad = make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    tri = np.concatenate([sph, quad.reshape(-1, 3, 3)]).astype(np.float32)
    dbvh, _ = build_dense(tri, leaf_target=32)
    return dbvh, tri


def _two_level():
    scene, _ = instanced_scene()
    v0 = np.asarray(scene.tri_v0)
    tri = np.stack([v0, v0 + np.asarray(scene.tri_e1), v0 + np.asarray(scene.tri_e2)], 1)
    return scene.dense, tri


TABLES = {"one-level": _one_level, "two-level": _two_level}


def _port(jd):
    return DenseBVH.from_numpy(*(np.asarray(getattr(jd, f)) for f in (
        "nodes16", "groups", "inst16", "prim_base", "world_lo", "world_hi")), device="cpu")


def _rays(n, seed, radius=7.0):
    gen = np.random.default_rng(seed)
    o = gen.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    d = (gen.normal(size=(n, 3)) * 1.2).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _ties(tri, o, d):
    """Rays whose two nearest hits (brute force, float64) are within RTOL."""
    tri = tri.astype(np.float64)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) > 1e-12, det, 1.0)
    s = o - v0[None]
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1[None])
    v = (d * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    ok = (np.abs(det) > 1e-12) & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6) & (t > 0)
    t = np.sort(np.where(ok, t, np.inf), axis=1)
    return t[:, 1] <= t[:, 0] * (1 + RTOL)


def _check_closest(got, want, ties):
    gp, wp = got.prim.numpy(), np.asarray(want.prim)
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=RTOL)
    differ = (gp != wp) & ~ties
    assert not differ.any(), f"{differ.sum()} prim mismatches outside ties"
    inst_differ = (got.inst.numpy() != np.asarray(want.inst)) & ~ties
    assert not inst_differ.any()


@pytest.mark.parametrize("level", sorted(TABLES))
@pytest.mark.parametrize("sort", [False, True])
def test_closest_vs_pallas(level, sort):
    jd, tri = TABLES[level]()
    o, d = _rays(700, seed=1)
    jfn = jtrace.sorted_closest_dense if sort else jtrace.intersect_closest_dense
    tfn = ttrace.sorted_closest_dense if sort else ttrace.intersect_closest_dense
    want = jfn(jd, jnp.asarray(o), jnp.asarray(d), interpret=True)
    got = tfn(_port(jd), torch.from_numpy(o), torch.from_numpy(d))
    assert (got.prim >= 0).float().mean() > 0.3
    _check_closest(got, want, _ties(tri, o, d))


@pytest.mark.parametrize("level", sorted(TABLES))
def test_closest_respects_tmax(level):
    jd, tri = TABLES[level]()
    o, d = _rays(500, seed=2)
    td = _port(jd)
    full = ttrace.intersect_closest_dense(td, torch.from_numpy(o), torch.from_numpy(d))
    cut = torch.where(full.prim >= 0, full.t * 0.5, torch.ones_like(full.t))
    want = jtrace.intersect_closest_dense(jd, jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(cut.numpy()), interpret=True)
    got = ttrace.intersect_closest_dense(td, torch.from_numpy(o), torch.from_numpy(d), cut)
    _check_closest(got, want, _ties(tri, o, d))
    found = got.prim >= 0
    assert bool((got.t[found] < cut[found]).all())


@pytest.mark.parametrize("level", sorted(TABLES))
@pytest.mark.parametrize("sort", [False, True])
def test_any_vs_pallas(level, sort):
    """Three tmax regimes: beyond the hit, before it, and zero."""
    jd, _ = TABLES[level]()
    o, d = _rays(600, seed=3)
    td = _port(jd)
    full = ttrace.intersect_closest_dense(td, torch.from_numpy(o), torch.from_numpy(d))
    t = full.t.numpy()
    jfn = jtrace.sorted_any_dense if sort else jtrace.intersect_any_dense
    tfn = ttrace.sorted_any_dense if sort else ttrace.intersect_any_dense
    for scale in (1.5, 0.5, 0.0):
        tmax = np.where(t < 1e29, t * scale, 50.0 * scale).astype(np.float32)
        want = np.asarray(jfn(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                              interpret=True))
        got = tfn(td, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
        np.testing.assert_array_equal(got.numpy(), want)
        if scale == 0.0:
            assert not got.any()


@pytest.mark.parametrize("level", sorted(TABLES))
def test_plain_vs_brute_force(level):
    """The plain traversal (table brute force) vs both packages' world-space
    brute force over the scene's triangles in global prim order."""
    jd, tri = TABLES[level]()
    o, d = _rays(400, seed=4)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    want = jbrute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
                  jnp.asarray(e2))
    T = torch.from_numpy
    brute = tbrute(T(o), T(d), T(np.ascontiguousarray(v0)), T(np.ascontiguousarray(e1)),
                   T(np.ascontiguousarray(e2)))
    ties = _ties(tri, o, d)
    np.testing.assert_array_equal(brute.prim.numpy() >= 0, np.asarray(want.prim) >= 0)
    np.testing.assert_allclose(brute.t.numpy(), np.asarray(want.t), rtol=RTOL)
    assert not ((brute.prim.numpy() != np.asarray(want.prim)) & ~ties).any()
    got = ttrace.intersect_closest_dense(_port(jd), T(o), T(d))
    np.testing.assert_array_equal(got.prim.numpy() >= 0, np.asarray(want.prim) >= 0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=RTOL)
    assert not ((got.prim.numpy() != np.asarray(want.prim)) & ~ties).any()


def test_plain_reports_ties():
    """plain_traverse's second-best t flags exactly the rays whose two
    nearest candidates (float64 brute force) are tied."""
    jd, tri = _one_level()
    o, d = _rays(600, seed=5)
    t, _, _, prim, _, t2 = ttrace.plain_traverse(
        _port(jd), torch.from_numpy(o), torch.from_numpy(d),
        torch.full((600,), 1e30), closest=True)
    found = (prim >= 0).numpy()
    tie = found & (t2 <= t * (1 + RTOL)).numpy()
    np.testing.assert_array_equal(tie, found & _ties(tri, o, d))


@pytest.mark.parametrize("level", sorted(TABLES))
@pytest.mark.parametrize("bf16", [False, True])
def test_derived_leaf_tables(level, bf16):
    """The port's derived tables (bvh/dense.py), on f32-only tables and on
    tables with the bf16 leaves: B1's leaf record g*C + j holds rows 0-9 of
    group g at slot j for j < c, the period of the group's node code (as
    _pack_groups_bf finds it), and prim -1 (zero geometry) for c <= j < C;
    B2's band pairs are groups_bf with each column's 32 rows contiguous."""
    jd, _ = TABLES[level]()
    if bf16:
        td = DenseBVH.from_numpy(**{k: np.asarray(getattr(jd, k)) for k in jd._fields
                                    if getattr(jd, k) is not None}, device="cpu")
    else:
        td = _port(jd)
    G = td.n_groups
    rows = td.groups.reshape(G, 16, 128).numpy()
    rec = td.leaf_rec.numpy()
    C = rec.shape[0] // G
    assert rec.shape == (G * C, 12) and td.leaf_rec.data_ptr() % 16 == 0
    rec = rec.reshape(G, C, 12)
    nodes = td.nodes16.numpy().reshape(-1, 16)
    periods = {}
    for code in np.rint(nodes[:, 12:14]).astype(np.int64).ravel():
        v = -(code + 1)
        if code < 0 and code != ttrace.ABSENT and v % 2 == 0:
            periods[(v // 2) // 8] = 1 << ((v // 2) % 8)
    assert periods and C == max(periods.values())
    for g, c in periods.items():
        want = rows[g, :10, :c].T                              # (c, 10)
        np.testing.assert_array_equal(rec[g, :c, 0:3], want[:, 0:3])
        np.testing.assert_array_equal(rec[g, :c, 4:7], want[:, 3:6])
        np.testing.assert_array_equal(rec[g, :c, 8:11], want[:, 6:9])
        np.testing.assert_array_equal(rec[g, :c, 3], want[:, 9])
        np.testing.assert_array_equal(rec[g, c:, 3], -1.0)
        assert not rec[g, c:, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11]].any()
        assert not rec[g, :c, [7, 11]].any()
    if not bf16:
        assert td.groups_bf2 is None
        return
    gbf = td.groups_bf.view(torch.int16).reshape(G, 32, 128).numpy()
    pairs = td.groups_bf2.view(torch.int16).numpy()
    assert pairs.shape == (G, 128, 32) and td.groups_bf2.data_ptr() % 16 == 0
    np.testing.assert_array_equal(pairs, gbf.transpose(0, 2, 1))
    # word i of column l is (band 0, band 1) of component i: rows 2i, 2i+1
    words = td.groups_bf2.view(torch.int32).numpy().view(np.uint32)
    g, lane, i = G - 1, 5, 4
    assert words[g, lane, i] == ((int(gbf[g, 2 * i, lane]) & 0xFFFF)
                                 | (int(gbf[g, 2 * i + 1, lane]) & 0xFFFF) << 16)


def test_morton_key():
    """The octant-major key, the mode the traversal wrappers sort by."""
    o, d = _rays(1000, seed=6, radius=3.0)
    lo, hi = np.array([-2, -1, -2], np.float32), np.array([2, 1.5, 2], np.float32)
    dead = np.random.default_rng(6).uniform(size=1000) < 0.3
    want = np.asarray(jmorton(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                              jnp.asarray(hi), dead=jnp.asarray(dead),
                              mode="octant_major"))
    got = ttrace.morton_key(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(lo), torch.from_numpy(hi),
                            dead=torch.from_numpy(dead))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_wrapper_counts_and_rejects():
    """On the CPU the wrappers run the plain version (counted there, no
    launch); bad inputs are refused before any traversal."""
    jd, _ = _one_level()
    td = _port(jd)
    o, d = _rays(64, seed=7)
    ttrace.reset_counts()
    ttrace.intersect_closest_dense(td, torch.from_numpy(o), torch.from_numpy(d))
    ttrace.intersect_any_dense(td, torch.from_numpy(o), torch.from_numpy(d),
                               torch.ones(64))
    assert ttrace.PLAIN_CALLS == {"closest": 1, "any": 1}
    assert ttrace.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(TypeError):
        ttrace.intersect_any_dense(td, torch.from_numpy(o).double(),
                                   torch.from_numpy(d), torch.ones(64))
    with pytest.raises(ValueError):
        ttrace.intersect_any_dense(td, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.ones(63))
    assert ttrace.max_steps(td) == 8 * td.n_nodes + 64


@pytest.mark.cuda
def test_kernel_vs_plain_on_gpu():
    """The CUDA kernel vs its plain version on one- and two-level tables
    (runs where a GPU is present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    for level in sorted(TABLES):
        jd, _ = TABLES[level]()
        td = _port(jd).to(dev)
        o, d = _rays(4096, seed=8)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        tm = torch.full((4096,), 1e30, device=dev)
        *raw, t2 = ttrace.plain_traverse(td, o, d, tm, closest=True)
        want = ttrace.to_hit(td, *raw)
        hit = ttrace.sorted_closest_dense(td, o, d, tm)
        found = want.prim >= 0
        assert torch.equal(hit.prim >= 0, found)
        assert torch.equal(hit.t, want.t)
        tie = t2 <= raw[0] * (1 + 1e-6)
        assert bool(((hit.prim == want.prim) & (hit.inst == want.inst) | tie).all())
        tmax = torch.where(found, want.t * 0.75, torch.full_like(want.t, 50.0))
        assert torch.equal(ttrace.sorted_any_dense(td, o, d, tmax),
                           ttrace.plain_traverse(td, o, d, tmax, closest=False))
        assert ttrace.truncated_rays(dev) == 0
