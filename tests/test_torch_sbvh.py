"""The port's spatial-split (SBVH) and rotation builders vs the JAX
package's on the CPU: ``build_bvh_hq``, ``_build_core_hq``,
``build_dense(hq=True)``, ``build_dense_tlas(hq=True)`` and
``optimize_bvh``; ``tests/test_sbvh.py``'s six checks and
``tests/test_bvh.py::test_optimize_bvh_rotations`` replayed on the port; and
the engines on ``hq`` tables, whose leaf groups may reference one triangle
more than once.

Tolerances: tables byte for byte; rotation counts equal; the replayed checks
with their own thresholds; B1's plain version equal to brute force (found,
t within 1e-6 relative, prim outside t-ties); B2's plain version equal to
the JAX kernel in interpret mode (closest on every lane, occlusion outside
near-tmax lanes), and within the JAX package's precision contract of brute
force where the JAX engine meets it. Skips where ``g++`` is absent (the
port raises there; the JAX package falls back); elsewhere the JAX package's
native builders are loaded first (``tests/torch_port.py::ensure_jax_native``,
whose recovery from a half-written library is tested here too)."""

import ctypes
import os
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh import builder as jbuilder  # noqa: E402
from physically_based_ray_tracer_tpu.bvh import dense as jdense  # noqa: E402
from physically_based_ray_tracer_tpu.bvh import native as jnative  # noqa: E402
from physically_based_ray_tracer_tpu.bvh.types import sah_cost as jsah_cost  # noqa: E402
from physically_based_ray_tracer_tpu.ops import pallas_bf16 as jb  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import builder as tbuilder  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays, sah_cost  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16, traverse  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.intersect import brute_force_intersect  # noqa: E402
from tests.test_sbvh import _mixed_tris, _rays  # noqa: E402
from tests.test_torch_tables import _same_bytes, _same_dense  # noqa: E402
from tests.test_torch_trace import _ties  # noqa: E402
from tests.test_torch_wave import _needs_gxx, jax_native  # noqa: E402, F401
from tests.torch_port import ensure_jax_native, instanced_parts  # noqa: E402

T_RTOL = 1e-6
BVH_FIELDS = ("nodes_box", "nodes_child", "tris", "prim_index", "tris_woop")


pytestmark = pytest.mark.usefixtures("jax_native")


def T(x):
    return torch.from_numpy(np.array(x))


def _oracle(tri, o, d):
    v0 = tri[:, 0]
    return brute_force_intersect(T(o), T(d), T(v0), T(tri[:, 1] - v0), T(tri[:, 2] - v0))


def _whole_library(path, tmp_path, tries=20):
    """The bytes of the library at ``path``, once a copy of them loads."""
    probe = tmp_path / "probe.so"
    for _ in range(tries):
        data = open(path, "rb").read()
        probe.write_bytes(data)
        try:
            ctypes.CDLL(str(probe))
            return data
        except OSError:
            time.sleep(0.5)
    raise AssertionError(f"{path} never loaded")


def test_ensure_jax_native_recovers_from_a_half_written_library(tmp_path, monkeypatch):
    """A library cut inside its ELF header (what a load sees early in the
    write) at a scratch copy of the SBVH loader's path, newer than its
    source, fails the JAX loader (``file too short``), which caches the
    failure; once the whole library is written there, ensure_jax_native
    clears the cached failure and loads it."""
    data = _whole_library(jnative._SBVH_SO_PATH, tmp_path)
    so = tmp_path / "libsbvh_builder.so"
    so.write_bytes(data[:32])
    monkeypatch.setattr(jnative, "_SBVH_SO_PATH", str(so))
    monkeypatch.setattr(jnative, "_sbvh_lib", None)
    monkeypatch.setattr(jnative, "_sbvh_tried", False)
    assert jnative.get_sbvh_lib() is None and jnative._sbvh_tried

    def write():
        time.sleep(1.0)
        part = tmp_path / "part.so"
        part.write_bytes(data)
        os.replace(part, so)
    writer = threading.Thread(target=write)
    writer.start()
    try:
        ensure_jax_native()
    finally:
        writer.join()
    assert jnative._sbvh_lib is not None and jnative.get_sbvh_lib() is jnative._sbvh_lib


# ---------------------------------------------------------------------------
# the builders, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf_size", [4, 16])
def test_build_bvh_hq_identical(leaf_size):
    tri = _mixed_tris()
    t = tbuilder.build_bvh_hq(tri, leaf_size=leaf_size)
    j = jbuilder.build_bvh_hq(tri, leaf_size=leaf_size)
    for f in BVH_FIELDS:
        _same_bytes(getattr(t, f), getattr(j, f), f)
    assert t.nodes_box.device.type == "cpu"
    assert tbuilder.bvh_depth(t) == jbuilder.bvh_depth(j)


@pytest.mark.parametrize("leaf_target", [32, 64])
def test_build_core_hq_identical(leaf_target):
    tri = _mixed_tris()
    t = tdense._build_core_hq(tri, leaf_target)
    j = jdense._build_core_hq(tri, leaf_target)
    _same_bytes(t[0], j[0], "nodes")
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        _same_bytes(a, b, "segment")
    assert t[2] == j[2]
    _same_bytes(t[3], j[3], "root_lo")
    _same_bytes(t[4], j[4], "root_hi")


@pytest.mark.parametrize("leaf_target,shape", [(32, False), (64, False), (16, True)])
def test_build_dense_hq_identical(leaf_target, shape):
    tri = _mixed_tris()
    t, tdepth = tdense.build_dense(tri, leaf_target=leaf_target, hq=True, shape=shape)
    j, jdepth = jdense.build_dense(tri, leaf_target=leaf_target, hq=True, shape=shape)
    _same_dense(t, j)
    assert tdepth == jdepth and t.stack_need <= tdepth
    std, _ = tdense.build_dense(tri, leaf_target=leaf_target, shape=shape)
    assert t.nodes16.shape != std.nodes16.shape or not torch.equal(t.nodes16, std.nodes16)


def test_build_dense_tlas_hq_identical():
    models, instances, _, _ = instanced_parts()
    mesh_tris = [m.corners.reshape(-1, 3, 3) for m in models]
    inst_mesh = [i.model for i in instances]
    transforms = np.stack([i.transform for i in instances])
    t, tmeta, tdepth = tdense.build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                               leaf_target=16, hq=True)
    j, jmeta, jdepth = jdense.build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                               leaf_target=16, hq=True)
    _same_dense(t, j)
    assert tdepth == jdepth and tmeta.tlas_cap == jmeta.tlas_cap
    _same_bytes(tmeta.blas_root, jmeta.blas_root, "blas_root")
    assert t.two_level and t.stack_need <= tdepth


# ---------------------------------------------------------------------------
# tests/test_sbvh.py's checks on the port
# ---------------------------------------------------------------------------

def test_sbvh_duplicates_referenced():
    tri = _mixed_tris()
    pid = tbuilder.build_bvh_hq(tri, leaf_size=4).prim_index.numpy()
    real = pid[pid >= 0]
    np.testing.assert_array_equal(np.unique(real), np.arange(tri.shape[0]))
    assert len(real) > tri.shape[0]


def test_sbvh_closest_matches_brute_force():
    """The lane engine on the SBVH tree."""
    tri = _mixed_tris()
    bvh = tbuilder.build_bvh_hq(tri, leaf_size=4)
    o, d = (np.asarray(x) for x in _rays(512))
    hit = traverse.intersect_closest(bvh, T(o), T(d))
    ref = _oracle(tri, o, d)
    np.testing.assert_array_equal(hit.prim.numpy(), ref.prim.numpy())
    np.testing.assert_allclose(hit.t.numpy(), ref.t.numpy(), rtol=1e-4, atol=1e-5)


def test_sbvh_anyhit_matches_brute_force():
    tri = _mixed_tris()
    bvh = tbuilder.build_bvh_hq(tri, leaf_size=4)
    o, d = (np.asarray(x) for x in _rays(512, seed=5))
    ref = _oracle(tri, o, d)
    occ = traverse.intersect_any(bvh, T(o), T(d), torch.full((512,), 1e30))
    np.testing.assert_array_equal(occ.numpy(), ref.prim.numpy() >= 0)


def test_sbvh_sah_not_worse_than_binned():
    tri = _mixed_tris()
    b_std = tbuilder.build_bvh(tri, leaf_size=4)
    b_hq = tbuilder.build_bvh_hq(tri, leaf_size=4)
    c_std = sah_cost(b_std.nodes_box.numpy(), b_std.nodes_child.numpy())
    c_hq = sah_cost(b_hq.nodes_box.numpy(), b_hq.nodes_child.numpy())
    assert c_hq <= c_std * 1.001, (c_hq, c_std)
    assert tbuilder.bvh_depth(b_hq) < 64


def test_dense_hq_core_contract():
    tri = _mixed_tris()
    nodes, segments, depth, lo, hi = tdense._build_core_hq(tri, 64)
    assert all(len(s) <= tdense.LEAF_W for s in segments)
    ids = np.unique(np.concatenate(segments))
    np.testing.assert_array_equal(ids, np.arange(tri.shape[0]))
    np.testing.assert_allclose(lo, tdense._build_core(tri, 64)[3], atol=1e-5)


def test_dense_hq_closest_vs_brute_force():
    """B1's plain version on an hq table (tests/test_sbvh.py's check, then
    the tighter one of this file: t within 1e-6 relative)."""
    tri = _mixed_tris()
    dbvh, _ = tdense.build_dense(tri, leaf_target=32, hq=True)
    o, d = (np.asarray(x) for x in _rays(1024, seed=11))
    ref = _oracle(tri, o, d)
    trace.reset_counts()
    hit = trace.intersect_closest_dense(dbvh, T(o), T(d))
    assert trace.PLAIN_CALLS["closest"] == 1
    np.testing.assert_array_equal(hit.prim.numpy(), ref.prim.numpy())
    m = hit.prim.numpy() >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], ref.t.numpy()[m], rtol=T_RTOL)


# ---------------------------------------------------------------------------
# optimize_bvh
# ---------------------------------------------------------------------------

def _clusters(gen):
    cl = []
    for _ in range(25):
        c = gen.uniform(-4, 4, 3)
        m = int(gen.integers(5, 80))
        p = c + gen.normal(0, 0.5, (m, 3))
        cl.append(np.stack([p, p + gen.normal(0, 0.1, (m, 3)),
                            p + gen.normal(0, 0.1, (m, 3))], 1))
    return np.concatenate(cl).astype(np.float32)


def test_optimize_bvh_rotations():
    """tests/test_bvh.py's check on the port: SAH does not increase and the
    lane engine's hits are unchanged (on the numpy builder's tree, as
    there)."""
    gen = np.random.default_rng(7)
    tri = _clusters(gen)
    bvh = tbuilder.build_bvh(tri, leaf_size=4, use_native=False)
    nb, nc = bvh.nodes_box.numpy().copy(), bvh.nodes_child.numpy().copy()
    c0 = sah_cost(nb, nc)
    n_rot = tbuilder.optimize_bvh(nb, nc, passes=6)
    c1 = sah_cost(nb, nc)
    assert n_rot > 0
    assert c1 <= c0 + 1e-5
    bvh2 = BVHArrays.from_numpy(nb, nc, bvh.tris.numpy(), bvh.prim_index.numpy(), device="cpu")
    o = gen.uniform(-5, 5, (256, 3)).astype(np.float32)
    d = gen.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h0 = traverse.intersect_closest(bvh, T(o), T(d), stack_depth=64, leaf_size=4)
    h1 = traverse.intersect_closest(bvh2, T(o), T(d), stack_depth=64, leaf_size=4)
    np.testing.assert_array_equal(h0.prim.numpy(), h1.prim.numpy())
    assert (h0.prim.numpy() >= 0).sum() >= 5


@pytest.mark.parametrize("which,passes", [("numpy", 6), ("native", 4), ("hq", 2)])
def test_optimize_bvh_matches_jax(which, passes):
    """The rotation count and the mutated node arrays equal the JAX
    optimizer's, on the numpy, native and SBVH trees."""
    gen = np.random.default_rng(7)
    tri = _clusters(gen)
    build = {"numpy": lambda: tbuilder.build_bvh(tri, leaf_size=4, use_native=False),
             "native": lambda: tbuilder.build_bvh(tri, leaf_size=4),
             "hq": lambda: tbuilder.build_bvh_hq(tri, leaf_size=4)}[which]
    bvh = build()
    tnb, tnc = bvh.nodes_box.numpy().copy(), bvh.nodes_child.numpy().copy()
    jnb, jnc = tnb.copy(), tnc.copy()
    n_t = tbuilder.optimize_bvh(tnb, tnc, passes=passes)
    n_j = jbuilder.optimize_bvh(jnb, jnc, passes=passes)
    assert n_t == n_j
    _same_bytes(tnb, jnb, "nodes_box")
    _same_bytes(tnc, jnc, "nodes_child")
    assert sah_cost(tnb, tnc) == jsah_cost(jnb, jnc)
    if which == "numpy":
        assert n_t > 0


# ---------------------------------------------------------------------------
# the dense engines' plain versions on hq tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hq_tables():
    """(triangles, JAX table, port table) of the mixed scene's hq dense
    build: duplicated triangle references across leaf groups."""
    _needs_gxx()
    tri = _mixed_tris()
    j, _ = jdense.build_dense(tri, leaf_target=32, hq=True)
    t, _ = tdense.build_dense(tri, leaf_target=32, hq=True)
    pids = t.groups.reshape(-1, tdense.GROUP_ROWS, tdense.LEAF_W)[:, 9, :]
    counts = np.bincount(np.unique(np.stack([np.repeat(np.arange(pids.shape[0]), 128),
                                             pids.reshape(-1).numpy()], 1), axis=0)[:, 1]
                         .astype(np.int64).clip(min=0))
    assert (counts > 1).any()          # a triangle in more than one group
    return tri, j, t


def test_plain_b1_on_hq_table_vs_brute_force(hq_tables):
    """B1's plain version, closest and any, on the hq table: found and
    occlusion equal to brute force, t within 1e-6 relative, prim equal
    outside t-ties."""
    tri, _, t = hq_tables
    o, d = (np.asarray(x) for x in _rays(1024, seed=13))
    ref = _oracle(tri, o, d)
    hit = trace.intersect_closest_dense(t, T(o), T(d))
    rp, gp = ref.prim.numpy(), hit.prim.numpy()
    np.testing.assert_array_equal(gp >= 0, rp >= 0)
    m = rp >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], ref.t.numpy()[m], rtol=T_RTOL)
    assert not ((gp != rp) & ~_ties(tri, o, d)).any()
    tmax = np.where(m, ref.t.numpy() * np.where(np.arange(1024) % 2, 1.5, 0.5),
                    5.0).astype(np.float32)
    occ = trace.intersect_any_dense(t, T(o), T(d), T(tmax))
    np.testing.assert_array_equal(occ.numpy(), m & (np.arange(1024) % 2 == 1))


def test_plain_b2_on_hq_table(hq_tables):
    """B2's plain version on the hq table vs the JAX kernel in interpret mode:
    winner keys, instances and t equal on every lane, near-tie lanes
    included (64% of these rays: a triangle referenced by two groups ties
    with itself, and the plain version's tile walk visits the groups in the
    kernel's order), and the winner decodes to the same prim id; occlusion
    (after the exact retest) equal outside near-tmax lanes. Against brute
    force: the JAX engine's found mismatches (the long thin triangles of
    this scene lose bf16 hits), the same prim on > 97% of the rays both
    hit, and the exactly refined t of those within 2e-6."""
    tri, j, t = hq_tables
    assert trace_bf16.has_bf16_tables(t)
    o, d = (np.asarray(x) for x in _rays(1024, seed=17))
    tm = np.full(1024, 1e30, np.float32)
    jt, jgk, ji = (np.asarray(x) for x in jb._call_bf16(
        j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), closest=True, interpret=True))
    pt, pgk, pi, near = trace_bf16.plain_traverse_bf16(t, T(o), T(d), T(tm), closest=True)
    differ = (pgk.numpy() != jgk) | (pi.numpy() != ji) | (pt.numpy() != jt)
    assert not differ.any(), f"{differ.sum()} lanes differ"
    assert near.numpy().mean() > 0.3
    want = jb._decode_fast(j, jnp.asarray(jt), jnp.asarray(jgk), jnp.asarray(ji))
    got = trace_bf16._decode_fast(t, pt, pgk, pi)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    ref = _oracle(tri, o, d)
    pb = ref.prim.numpy()
    h = trace_bf16.intersect_closest_bf16(t, T(o), T(d))
    p16 = h.prim.numpy()
    want = jb._decode_refine(j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                             jnp.asarray(jt), jnp.asarray(jgk), jnp.asarray(ji))
    np.testing.assert_array_equal(p16, np.asarray(want.prim))
    both = (p16 >= 0) & (pb >= 0)
    ok = both & (p16 == pb)
    assert ok.sum() / max(both.sum(), 1) > 0.97 and both.mean() > 0.3
    np.testing.assert_allclose(h.t.numpy()[ok], ref.t.numpy()[ok], rtol=2e-6, atol=2e-6)
    # occlusion, tmax around the hits
    tmax = np.where(pb >= 0, ref.t.numpy() * np.where(np.arange(1024) % 2, 1.5, 0.5),
                    5.0).astype(np.float32)
    want_o = np.asarray(jb.intersect_any_bf16(j, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(tmax), interpret=True))
    near_tm = trace_bf16.plain_traverse_bf16(t, T(o), T(d), T(tmax), closest=False)[2].numpy()
    got_o = trace_bf16.intersect_any_bf16(t, T(o), T(d), T(tmax)).numpy()
    assert 0.1 < want_o.mean() < 0.9
    np.testing.assert_array_equal(got_o & ~near_tm, want_o & ~near_tm)


@pytest.mark.cuda
def test_hq_kernels_vs_plain_on_gpu(hq_tables):
    """Kernels B1 and B2 on the hq table vs their plain versions (runs where
    a GPU is present): B1 equal, B2 equal outside near-tie lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    _, _, t = hq_tables
    td = t.to(dev)
    o, d = (T(np.asarray(x)).to(dev) for x in _rays(4096, seed=19))
    tm = torch.full((4096,), 1e30, device=dev)
    k = trace.intersect_closest_dense(td, o, d, tm)
    p = trace.intersect_closest_dense(t, o.cpu(), d.cpu(), tm.cpu())
    assert torch.equal(k.prim.cpu(), p.prim) and torch.equal(k.t.cpu(), p.t)
    t_k, gk_k, i_k = trace_bf16._call_bf16(td, o, d, tm, closest=True)
    t_p, gk_p, i_p, near = trace_bf16.plain_traverse_bf16(td, o, d, tm, closest=True)
    assert bool((((gk_k == gk_p) & (i_k == i_p) & (t_k == t_p)) | near).all())
