"""BVH refit and the versioned BVH cache of the port against the JAX
package, on tests/test_refit_cache.py's deformed spheres.

Tolerance: refit and cache are numpy copies, so the refit tables equal the
JAX package's byte for byte, and a cache written by either package loads in
the other with every stored table equal byte for byte. The refit dense
table's derived tables (``leaf_rec``, ``groups_bf2``) equal the ones
``DenseBVH.__post_init__`` builds from its new ``groups`` (a refit that
kept the old ones would trace the old geometry in kernels B1-B3 while the
plain versions trace the new). Traversal of refit tables (the plain f32
dense version and the wave engine's plain levels) against brute force on
the deformed triangles: the same prim on every ray, t within rtol 1e-4,
atol 1e-5 (tests/test_refit_cache.py's)."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh import cache as jcache  # noqa: E402
from physically_based_ray_tracer_tpu.bvh import refit as jrefit  # noqa: E402
from physically_based_ray_tracer_tpu.bvh.builder import build_bvh as jbuild_bvh  # noqa: E402
from physically_based_ray_tracer_tpu.bvh.dense import build_dense as jbuild_dense  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import cache, refit  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.builder import build_bvh  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, traverse_packet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.intersect import brute_force_intersect  # noqa: E402
from tests.test_refit_cache import _deform  # noqa: E402
from tests.test_torch_tables import DENSE_FIELDS, _same_bytes, _same_dense  # noqa: E402

BVH_FIELDS = ("nodes_box", "nodes_child", "tris", "prim_index", "tris_woop")


def _sphere(lat=14, lon=20):
    return make_sphere(radius=1.0, lat=lat, lon=lon)[0].reshape(-1, 3, 3)


def _port_bvh(jbvh):
    return BVHArrays.from_numpy(*(np.asarray(getattr(jbvh, f)) for f in BVH_FIELDS),
                                device="cpu")


def _port_dense(jd):
    return tdense.DenseBVH.from_numpy(
        *(np.asarray(getattr(jd, f)) for f in DENSE_FIELDS),
        groups_bf=np.asarray(jd.groups_bf), glo=np.asarray(jd.glo),
        pids_c=np.asarray(jd.pids_c), device="cpu")


def _same_bvh(t, j):
    for f in BVH_FIELDS:
        _same_bytes(getattr(t, f), getattr(j, f), f)


def _rays(n, seed=0):
    """tests/test_refit_cache.py's rays, as torch tensors."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 5.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _oracle(tri, o, d):
    tri = torch.from_numpy(np.ascontiguousarray(tri, np.float32))
    return brute_force_intersect(o, d, tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])


def _same_hits(hit, ref):
    np.testing.assert_array_equal(hit.prim.numpy(), ref.prim.numpy())
    m = hit.prim.numpy() >= 0
    assert m.mean() > 0.3
    np.testing.assert_allclose(hit.t.numpy()[m], ref.t.numpy()[m], rtol=1e-4, atol=1e-5)


def test_refit_bvh_matches_jax_and_brute_force():
    """refit_bvh of the same classic BVH (leaf_size 4) to the deformed
    sphere: byte-equal to the JAX package's; the wave engine's plain
    version on it equals brute force on the deformed triangles."""
    tri = _sphere()
    jbvh = jbuild_bvh(tri, leaf_size=4)
    tri2 = _deform(tri)
    want = jrefit.refit_bvh(jbvh, tri2)
    got = refit.refit_bvh(_port_bvh(jbvh), tri2)
    _same_bvh(got, want)
    assert got.nodes_box.device.type == "cpu"
    o, d = _rays(512)
    hit = traverse_packet.intersect_closest_wave(got, o, d, leaf_size=4)
    _same_hits(hit, _oracle(tri2, o, d))


def test_refit_identity_keeps_boxes():
    """tests/test_refit_cache.py's test of the same name, on the port."""
    tri = _sphere(8, 10)
    bvh = build_bvh(tri, leaf_size=4)
    re = refit.refit_bvh(bvh, tri)
    assert (re.nodes_box[:, 0:3] >= bvh.nodes_box[:, 0:3] - 1e-5).all()
    assert torch.equal(re.nodes_child, bvh.nodes_child)


def test_refit_dense_matches_jax_rebuilds_derived_tables():
    """refit_dense of the same single-level table: byte-equal to the JAX
    package's (bf16 tables included); stack_need counted anew; leaf_rec and
    groups_bf2 equal the tables __post_init__ builds from the refit groups
    and differ from the unrefit table's; the plain f32 traversal of the
    refit table equals brute force on the deformed triangles."""
    tri = _sphere()
    jd, _ = jbuild_dense(tri, leaf_target=32)
    td = _port_dense(jd)
    tri2 = _deform(tri, amp=0.5, seed=3)
    want = jrefit.refit_dense(jd, tri2)
    got = refit.refit_dense(td, tri2)
    _same_dense(got, want)
    assert got.stack_need == tdense.stack_need(got.nodes16.numpy(), got.inst16.numpy())
    assert torch.equal(got.leaf_rec, tdense._leaf_records(got.groups))
    assert torch.equal(got.groups_bf2.view(torch.int16),
                       tdense._band_pairs(got.groups_bf).view(torch.int16))
    assert not torch.equal(got.leaf_rec, td.leaf_rec)
    assert not torch.equal(got.groups_bf2.view(torch.int16), td.groups_bf2.view(torch.int16))
    o, d = _rays(1024, seed=7)
    _same_hits(trace.intersect_closest_dense(got, o, d), _oracle(tri2, o, d))
    two_level, _, _ = tdense.build_dense_tlas([tri], [0, 0], np.stack([np.eye(4)] * 2))
    with pytest.raises(AssertionError, match="refresh_tlas"):
        refit.refit_dense(two_level, tri2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_round_trip_across_packages(tmp_path, writer):
    """A cache written by one package loads in the other: every stored
    table byte for byte, the port's derived tables and stack need rebuilt
    on load. The hash binds geometry and build options in both."""
    tri = _sphere(8, 10)
    jbvh = jbuild_bvh(tri, leaf_size=4)
    jd, _ = jbuild_dense(tri, leaf_target=16)
    pb, pd = str(tmp_path / "mesh.bvh.npz"), str(tmp_path / "mesh.dense.npz")
    if writer == "jax":
        jcache.save_bvh(pb, jbvh, tri, params="leaf4")
        jcache.save_dense(pd, jd, tri)
    else:
        cache.save_bvh(pb, _port_bvh(jbvh), tri, params="leaf4")
        cache.save_dense(pd, _port_dense(jd), tri)
    got_b = cache.load_bvh(pb, tri, params="leaf4", device="cpu")
    _same_bvh(got_b, jbvh)
    _same_bvh(_port_bvh(jcache.load_bvh(pb, tri, params="leaf4")), jbvh)
    got_d = cache.load_dense(pd, tri, device="cpu")
    _same_dense(got_d, jd)
    _same_dense(_port_dense(jcache.load_dense(pd, tri)), jd)
    assert torch.equal(got_d.leaf_rec, tdense._leaf_records(got_d.groups))
    assert got_d.stack_need == _port_dense(jd).stack_need
    for load, jload, path, params in ((cache.load_bvh, jcache.load_bvh, pb, "leaf4"),
                                      (cache.load_dense, jcache.load_dense, pd, "")):
        assert load(path, tri, params="other", device="cpu") is None
        assert load(path, tri * 1.01, params=params, device="cpu") is None
        assert jload(path, tri * 1.01, params=params) is None
    assert cache.load_bvh(pd, tri, device="cpu") is None      # wrong layout
    assert cache.load_dense(pb, tri, params="leaf4", device="cpu") is None


def test_cache_version_and_extensionless_path(tmp_path):
    """An extensionless path names the same .npz for save and load; a file
    of another FORMAT_VERSION, a missing file and a damaged one load as
    None in both packages."""
    tri = _sphere(6, 8)
    bvh = build_bvh(tri, leaf_size=4)
    p = str(tmp_path / "noext")
    cache.save_bvh(p, bvh, tri)
    assert os.path.exists(p + ".npz")
    _same_bvh(cache.load_bvh(p, tri, device="cpu"), jcache.load_bvh(p, tri))
    z = dict(np.load(p + ".npz"))
    z["version"] = np.int64(cache.FORMAT_VERSION - 1)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **z)
    assert cache.FORMAT_VERSION == jcache.FORMAT_VERSION
    assert cache.load_bvh(old, tri, device="cpu") is None and jcache.load_bvh(old, tri) is None
    assert cache.load_bvh(str(tmp_path / "absent"), device="cpu") is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert cache.load_bvh(str(bad), device="cpu") is None


def test_cached_build_helper(tmp_path):
    """tests/test_refit_cache.py's test of the same name, on the port: the
    builder runs once, the second call loads it."""
    tri = _sphere(6, 8)
    p = str(tmp_path / "c.npz")
    calls = []

    def builder(t):
        calls.append(1)
        return build_bvh(t, leaf_size=4)

    b1, hit1 = cache.cached_build_bvh(p, tri, builder, device="cpu")
    b2, hit2 = cache.cached_build_bvh(p, tri, builder, device="cpu")
    assert (hit1, hit2) == (False, True)
    assert len(calls) == 1
    assert torch.equal(b1.nodes_box, b2.nodes_box) and torch.equal(b1.tris_woop, b2.tris_woop)
