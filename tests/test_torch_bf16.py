"""The port's bf16 engine (ops/trace_bf16.py, kernel B2's plain version and
its wrappers) vs the JAX package's (ops/pallas_bf16.py, the Pallas kernel in
interpret mode), on one- and two-level tables built identically by both.

Tolerances:
  * the plain version and the Pallas kernel run the same bf16 arithmetic
    (each operation in f32, rounded to bf16, as both frameworks compute it
    on the CPU), so found masks, winner keys, instances and t are EQUAL,
    except on near-tie lanes (ops/trace_bf16.py::plain_traverse_bf16):
    there the order groups are visited in (the TPU's 1024-ray tile, the
    plain version's group order) may legitimately pick another winner. The
    measured near-tie share is 1.2% of 2048 sphere rays; the tests require
    under 2%. Occlusion verdicts are equal outside the near-tmax lanes.
  * decodes of the same kernel outputs: prim, instance and found exact; the
    refined t within rtol=atol=2e-6 (the JAX test's bound; the frameworks
    round the three-term dot products differently), u and v too on a
    one-level table and within atol=1e-4 on a two-level one (see the test);
  * the JAX package's own contract tests (tests/test_pallas_bf16.py) are
    replayed on the port against f32 brute force with their thresholds;
  * images: >= 98% of pixels allclose at rtol=2e-4, atol=2e-5 (the bf16
    engine's near-tie lanes add forks to those of tests/test_torch_render.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh.dense import build_dense as jbuild_dense  # noqa: E402
from physically_based_ray_tracer_tpu.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.ops import pallas_bf16 as jb  # noqa: E402
from physically_based_ray_tracer_tpu.render import integrator as jintegrator  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import render_sample as jrender  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace as ttrace  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace_bf16 as tb  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import integrator as tintegrator  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import procedural as tproc  # noqa: E402
from tests.scenes import sphere_scene  # noqa: E402
from tests.test_pallas_bf16 import _rays as sphere_rays  # noqa: E402
from tests.test_pallas_bf16 import brute_closest  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

NEAR_SHARE = 0.02


def T(x):
    """numpy (or a read-only JAX result) -> a torch tensor of its own."""
    return torch.from_numpy(np.array(x))


def _one_level():
    sph = make_sphere(radius=1.0, lat=16, lon=24)[0].reshape(-1, 3, 3)
    quad = make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    tri = np.concatenate([sph, quad.reshape(-1, 3, 3)]).astype(np.float32)
    return jbuild_dense(tri, leaf_target=16, shape=True)[0]


def _two_level():
    return instanced_scene()[0].dense


def _port(jd):
    """The port's DenseBVH with the JAX package's tables (bf16 bits kept)."""
    return tdense.DenseBVH.from_numpy(**{k: np.asarray(getattr(jd, k)) for k in jd._fields
                                         if getattr(jd, k) is not None}, device="cpu")


def _rays(n, seed, radius=7.0):
    """Rays from a sphere of ``radius`` towards the scene's middle."""
    gen = np.random.default_rng(seed)
    o = gen.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    d = (gen.normal(size=(n, 3)) * 1.2).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _tmax(o, seed):
    """Occlusion limits around the distance to the scene's middle, so that
    both verdicts occur; 10% of the rays dead (tmax = 0)."""
    gen = np.random.default_rng(seed)
    tm = np.linalg.norm(o, axis=1) * gen.uniform(0.3, 1.3, o.shape[0])
    return np.where(gen.uniform(size=o.shape[0]) < 0.1, 0.0, tm).astype(np.float32)


@pytest.fixture(scope="module")
def tables():
    out = {}
    for level, make in (("one-level", _one_level), ("two-level", _two_level)):
        jd = make()
        out[level] = (jd, _port(jd))
    return out


@pytest.fixture(scope="module")
def jax_kernel(tables):
    """JAX _call_bf16 (interpret mode) outputs per (level, mode), 2048 rays."""
    cache = {}

    def get(level, closest):
        if (level, closest) not in cache:
            jd, _ = tables[level]
            o, d = _rays(2048, seed=11)
            tm = np.full(2048, 1e30, np.float32) if closest else _tmax(o, 12)
            out = jb._call_bf16(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                closest=closest, interpret=True)
            cache[(level, closest)] = (o, d, tm, [np.asarray(x) for x in out])
        return cache[(level, closest)]
    return get


def test_bf16_constants_match_reference():
    """The plain version's bf16 constants are the reference's ``_bf`` values."""
    K = tb.bf16_constants("cpu")
    for name, x in (("1e-8", 1e-8), ("1e4", 1e4), ("1e8", 1e8), ("0.01", 0.01),
                    ("apron", jb.APRON), ("1/apron", 1.0 / jb.APRON),
                    ("0.05", 0.05), ("1e30", 1e30)):
        assert K[name].view(torch.int16).item() == int(np.asarray(jb._bf(x)).view(np.int16)), name
    assert (tb.APRON, tb.GLO_SMEM_LIMIT, tb.REFINE_WIN) == (jb.APRON, jb.GLO_SMEM_LIMIT,
                                                           jb.REFINE_WIN)


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 value (ties to even), as float64: rounded
    at the bf16 ulp of x's binade (2^-133 below the normal range), inf past
    the largest finite bf16. A single rounding: torch's float64 -> bf16
    conversion goes through float32 and would round twice."""
    _, e = np.frexp(x)
    ulp = np.ldexp(1.0, np.maximum(e - 8, -133))
    with np.errstate(over="ignore", invalid="ignore"):
        r = np.round(x / ulp) * ulp
    return np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)


def _bf16_operands(gen, n) -> np.ndarray:
    """(n, 2) finite bf16 bit patterns: uniform over all finite patterns,
    plus pairs with a subnormal operand and pairs whose exponents differ by
    14-18 (where the exact sum needs more than f32's 24 bits)."""
    bits = gen.integers(0, 1 << 16, (3 * n, 2), dtype=np.uint16)
    pairs = bits[((bits & 0x7F80) != 0x7F80).all(axis=1)][: n // 2]
    sub = gen.integers(0, 1 << 16, (n // 4, 2), dtype=np.uint16)
    sub[:, 0] &= 0x807F                                    # exponent 0
    sub[:, 1] = np.where((sub[:, 1] & 0x7F80) == 0x7F80, sub[:, 1] & 0x807F, sub[:, 1])
    gap = gen.integers(0, 1 << 16, (n // 4, 2), dtype=np.uint16) & 0x807F
    e0 = gen.integers(19, 240, n // 4)
    e1 = e0 - gen.integers(14, 19, n // 4)
    gap[:, 0] |= (e0 << 7).astype(np.uint16)
    gap[:, 1] |= (e1 << 7).astype(np.uint16)
    return np.concatenate([pairs, sub, gap[:, ::-1], gap])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "fma"])
def test_bf16_rounding_premise(op):
    """What kernel B2's packed bf16x2 sweep relies on (csrc/traverse_bf16.cu):
    for an add, a subtract or a multiply of two bf16 operands, the plain
    version's f32 operation rounded to bf16 equals the correctly rounded
    result (float64, rounded once at the bf16 ulp), so a native bf16
    operation gives the same bits; a fused multiply-add rounds once where the
    plain version rounds twice, and differs. ~10^6 seeded operand pairs."""
    gen = np.random.default_rng(21)
    ab = torch.from_numpy(_bf16_operands(gen, 1 << 20).view(np.int16)).view(torch.bfloat16)
    a, b = ab[:, 0], ab[:, 1]
    a64, b64 = a.double().numpy(), b.double().numpy()
    if op == "fma":
        c = b.flip(0)
        emulated = ((a.float() * b.float()).to(torch.bfloat16).float()
                    + c.float()).to(torch.bfloat16)
        exact = _bf16_round(a64 * b64 + c.double().numpy())
    else:
        f32, f64 = {"add": (torch.add, np.add), "sub": (torch.sub, np.subtract),
                    "mul": (torch.mul, np.multiply)}[op]
        emulated = f32(a.float(), b.float()).to(torch.bfloat16)
        with np.errstate(over="ignore"):       # products past 2^128: inf
            exact = _bf16_round(f64(a64, b64))
    want = torch.from_numpy(exact).float().to(torch.bfloat16)   # exact: representable
    same = emulated.view(torch.int16) == want.view(torch.int16)
    if op == "fma":
        assert int((~same).sum()) > 0
    else:
        assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} differ"


@pytest.mark.parametrize("level", ["one-level", "two-level"])
def test_plain_closest_vs_pallas(tables, jax_kernel, level):
    _, td = tables[level]
    o, d, tm, (jt, jgk, ji) = jax_kernel(level, True)
    t, gk, inst, near = (x.numpy() for x in tb.plain_traverse_bf16(
        td, T(o), T(d), T(tm), closest=True))
    assert (gk >= 0).mean() > 0.3
    np.testing.assert_array_equal(gk >= 0, jgk >= 0)
    differ = (gk != jgk) | (inst != ji) | (t != jt)
    assert not (differ & ~near).any(), f"{(differ & ~near).sum()} lanes differ"
    assert near.mean() < NEAR_SHARE, near.mean()


@pytest.mark.parametrize("level", ["one-level", "two-level"])
def test_plain_any_vs_pallas(tables, jax_kernel, level):
    _, td = tables[level]
    o, d, tm, (jt, jgk, _) = jax_kernel(level, False)
    jcert, junc = jt > 0.5, jgk > 0
    cert, unc, near = (x.numpy() for x in tb.plain_traverse_bf16(
        td, T(o), T(d), T(tm), closest=False))
    assert 0.1 < cert.mean() < 0.9 and (unc & ~cert).any()
    np.testing.assert_array_equal(cert & ~near, jcert & ~near)
    # the tile keeps sweeping certain lanes, so compare uncertain-and-not-certain
    np.testing.assert_array_equal((unc & ~cert) & ~near, (junc & ~jcert) & ~near)
    assert near.mean() < NEAR_SHARE, near.mean()
    assert not (cert | unc)[tm <= 0].any()


@pytest.mark.parametrize("level", ["one-level", "two-level"])
def test_decode_matches_jax(tables, jax_kernel, level):
    """_decode_fast / _decode_refine on the same (tb, gk, inst) arrays."""
    jd, td = tables[level]
    o, d, tm, (jt, jgk, ji) = jax_kernel(level, True)
    want = jb._decode_fast(jd, jnp.asarray(jt), jnp.asarray(jgk), jnp.asarray(ji))
    got = tb._decode_fast(td, T(jt), T(jgk), T(ji))
    for f in ("t", "u", "v", "prim", "inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    want = jb._decode_refine(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                             jnp.asarray(jt), jnp.asarray(jgk), jnp.asarray(ji))
    got = tb._decode_refine(td, T(o), T(d), T(tm), T(jt), T(jgk), T(ji))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(want.inst))
    assert (got.prim.numpy() >= 0).mean() > 0.3
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=2e-6, atol=2e-6)
    # XLA evaluates the instance transform's einsum as an FMA chain, PyTorch
    # without FMA: the object-space origin (~7 units out) differs in its last
    # bit on ~12% of two-level rays, and the barycentrics' cancellation over
    # ~0.2-unit triangles turns that into up to ~2e-5
    uv_atol = 2e-6 if level == "one-level" else 1e-4
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=2e-6, atol=uv_atol, err_msg=f)


@pytest.mark.parametrize("level", ["one-level", "two-level"])
@pytest.mark.parametrize("sort", [False, True])
def test_wrappers_vs_jax(tables, level, sort):
    """intersect_/sorted_ closest (exact decode) and any (after the exact
    resolve of uncertain lanes) equal the JAX package's outside the near
    lanes; the near masks do not depend on the sweep lanes, so the plain
    version's masks in caller order serve the sorted wrappers too."""
    jd, td = tables[level]
    o, d = _rays(1024, seed=13)
    tm = _tmax(o, 14)
    jo, jdd, jtm = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    near_c = tb.plain_traverse_bf16(td, T(o), T(d), T(np.full(1024, 1e30, np.float32)),
                                    closest=True)[3].numpy()
    near_a = tb.plain_traverse_bf16(td, T(o), T(d), T(tm), closest=False)[2].numpy()
    if sort:
        want_h = jb.sorted_closest_bf16(jd, jo, jdd, interpret=True)
        want_o = jb.sorted_any_bf16(jd, jo, jdd, jtm, interpret=True)
        got_h = tb.sorted_closest_bf16(td, T(o), T(d))
        got_o = tb.sorted_any_bf16(td, T(o), T(d), T(tm))
    else:
        want_h = jb.intersect_closest_bf16(jd, jo, jdd, interpret=True)
        want_o = jb.intersect_any_bf16(jd, jo, jdd, jtm, interpret=True)
        got_h = tb.intersect_closest_bf16(td, T(o), T(d))
        got_o = tb.intersect_any_bf16(td, T(o), T(d), T(tm))
    for f in ("prim", "inst"):
        g, w = getattr(got_h, f).numpy(), np.asarray(getattr(want_h, f))
        assert not ((g != w) & ~near_c).any(), f
    same = (got_h.prim.numpy() == np.asarray(want_h.prim)) & (got_h.prim.numpy() >= 0)
    assert same.mean() > 0.3
    np.testing.assert_allclose(got_h.t.numpy()[same], np.asarray(want_h.t)[same],
                               rtol=2e-6, atol=2e-6)
    got_o, want_o = got_o.numpy(), np.asarray(want_o)
    assert 0.1 < want_o.mean() < 0.9
    np.testing.assert_array_equal(got_o & ~near_a, want_o & ~near_a)


# --- the JAX package's contract tests (tests/test_pallas_bf16.py), replayed
# on the port's own builders and engine against f32 brute force

@pytest.fixture(scope="module")
def port_sphere():
    tri = tproc.make_sphere(radius=1.0, lat=16, lon=24)[0].reshape(-1, 3, 3)
    return tri, tdense.build_dense(tri, leaf_target=16, shape=True)[0]


def test_contract_closest_vs_brute_force(port_sphere):
    tri, db = port_sphere
    o, d = sphere_rays(2048)
    pb, tbf = brute_closest(tri, o, d)
    h = tb.intersect_closest_bf16(db, T(o), T(d))
    p16, t16 = h.prim.numpy(), h.t.numpy()
    assert np.mean((p16 >= 0) != (pb >= 0)) < 0.005
    both = (p16 >= 0) & (pb >= 0)
    same = both & (p16 == pb)
    assert same.sum() / max(both.sum(), 1) > 0.97
    np.testing.assert_allclose(t16[same], tbf[same], rtol=2e-6, atol=2e-6)
    diff = both & (p16 != pb)
    if diff.any():
        P1 = o[diff] + tbf[diff, None] * d[diff]
        P2 = o[diff] + t16[diff, None] * d[diff]
        assert np.linalg.norm(P1 - P2, axis=-1).max() < 0.02


def test_contract_exact_uv_of_selected_prim(port_sphere):
    tri, db = port_sphere
    o, d = sphere_rays(512, seed=7)
    h = tb.intersect_closest_bf16(db, T(o), T(d))
    p = h.prim.numpy()
    sel = p >= 0
    v0 = tri[np.maximum(p, 0), 0]
    e1 = tri[np.maximum(p, 0), 1] - v0
    e2 = tri[np.maximum(p, 0), 2] - v0
    P = np.cross(d.astype(np.float64), e2)
    det = np.sum(e1 * P, -1)
    inv = 1.0 / np.where(np.abs(det) > 1e-12, det, 1.0)
    tv = o - v0
    u = np.sum(tv * P, -1) * inv
    q = np.cross(tv, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    min_uv = np.minimum(np.minimum(u, v), 1.0 - u - v)
    interior = sel & (min_uv >= 1e-4)
    np.testing.assert_allclose(h.u.numpy()[interior], u[interior], atol=1e-4)
    np.testing.assert_allclose(h.v.numpy()[interior], v[interior], atol=1e-4)
    np.testing.assert_allclose(h.t.numpy()[sel], t[sel], rtol=1e-5)
    np.testing.assert_allclose(h.u.numpy()[sel], np.clip(u, 0, 1)[sel], atol=0.025)


def test_contract_occlusion_vs_brute(port_sphere):
    tri, db = port_sphere
    o, d = sphere_rays(2048, seed=3)
    pb, tbf = brute_closest(tri, o, d)
    tmax = np.full(2048, 2.5, np.float32)
    occ_true = (pb >= 0) & (tbf < tmax)
    occ = tb.intersect_any_bf16(db, T(o), T(d), T(tmax)).numpy()
    assert np.mean(occ != occ_true) < 0.005
    assert not tb.intersect_any_bf16(db, T(o), T(d), torch.zeros(2048)).any()


def test_contract_two_level_instances():
    sph = tproc.make_sphere(radius=1.0, lat=12, lon=16)[0].reshape(-1, 3, 3)
    quad = tproc.make_quad([-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5]
                           )[0].reshape(-1, 3, 3)
    Ts = [np.eye(4, dtype=np.float32) for _ in range(3)]
    Ts[0][:3, 3] = [-1.5, 0, 0]
    Ts[1][:3, 3] = [1.5, 0, 0]
    db, _, _ = tdense.build_dense_tlas([sph, quad], [0, 0, 1], Ts, leaf_target=16,
                                       shape=True)
    world = np.concatenate([[sph, sph, quad][i] @ Ts[i][:3, :3].T + Ts[i][:3, 3]
                            for i in range(3)])
    o, d = sphere_rays(1024, center=(0, 0.5, 4.0), spread=0.25, seed=5)
    pb, tbf = brute_closest(world, o, d)
    h = tb.intersect_closest_bf16(db, T(o), T(d))
    p16, t16 = h.prim.numpy(), h.t.numpy()
    assert np.mean((p16 >= 0) != (pb >= 0)) < 0.01
    both = (p16 >= 0) & (pb >= 0)
    same = both & (p16 == pb)
    assert same.sum() / max(both.sum(), 1) > 0.97
    np.testing.assert_allclose(t16[same], tbf[same], rtol=2e-5, atol=2e-5)
    starts = np.concatenate([[0], np.cumsum([len(sph), len(sph), len(quad)])[:-1]])
    inst_true = np.searchsorted(starts, np.maximum(pb, 0), side="right") - 1
    assert (h.inst.numpy()[same] == inst_true[same]).mean() > 0.999


def test_contract_occlusion_edge_graze():
    """Shadow rays just outside a quad's edge (inside the 0.02 apron) stay
    visible after the exact resolve; just inside, and across the internal
    diagonal, they are occluded (the JAX package's r5 regression)."""
    tri = tproc.make_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])[0].reshape(-1, 3, 3)
    db, _ = tdense.build_dense(tri, leaf_target=16, shape=True)
    B = 1024
    rng = np.random.RandomState(7)
    s = rng.uniform(-0.8, 0.8, B).astype(np.float32)
    side = rng.randint(0, 4, B)
    edge_pt = np.stack([np.where(side == 0, s, np.where(side == 1, 1.0,
                        np.where(side == 2, s, -1.0))),
                        np.where(side == 0, -1.0, np.where(side == 1, s,
                        np.where(side == 2, 1.0, s)))], axis=1)
    outward = np.stack([np.where(side == 0, 0.0, np.where(side == 1, 1.0,
                        np.where(side == 2, 0.0, -1.0))),
                        np.where(side == 0, -1.0, np.where(side == 1, 0.0,
                        np.where(side == 2, 1.0, 0.0)))], axis=1)
    kind = rng.randint(0, 3, B)          # 0 = outside, 1 = inside, 2 = diagonal
    eps = 0.01
    aim = np.where((kind == 0)[:, None], edge_pt + outward * eps,
                   np.where((kind == 1)[:, None], edge_pt - outward * eps,
                            np.stack([s, -s], axis=1)))
    aim = np.where((kind == 2)[:, None],
                   np.stack([s, s + rng.uniform(-eps, eps, B).astype(np.float32)],
                            axis=1), aim)
    o = np.concatenate([aim, np.full((B, 1), 3.0, np.float32)], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (B, 1))
    ttrace.reset_counts()
    occ = tb.intersect_any_bf16(db, T(o), T(d), torch.full((B,), 6.0)).numpy()
    assert ttrace.PLAIN_CALLS["any"] == 1        # the exact resolve ran
    assert occ[kind == 0].mean() < 0.02
    assert occ[kind == 1].all()
    assert occ[kind == 2].all()


# --- the integrator

@pytest.mark.parametrize("which", ["sphere", "instanced"])
def test_render_sample_bf16_matches_jax(which):
    if which == "sphere":
        jscene, jcam = sphere_scene()
        cfg = RenderConfig(width=24, height=24, bounces=2, antialias=False,
                           skybox=False, accumulate=False, traversal="pallas",
                           leaf_precision="bf16")
    else:
        jscene, jcam = instanced_scene()
        cfg = SLICE_CFG.replace(leaf_precision="bf16")
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    want_c, want_t = jrender(jscene, jcam, cfg, jax.random.key(0), 0, jnp.asarray(ids))
    tb.reset_counts()
    got_c, got_t = tintegrator.render_sample(port_scene(jscene), port_camera(jcam),
                                             port_config(cfg), 0, 0, T(ids))
    assert tb.PLAIN_CALLS["closest"] > 0 and tb.PLAIN_CALLS["any"] > 0
    want_c = np.asarray(want_c)
    assert want_c.mean() > 1e-3
    close = np.isclose(got_c.numpy(), want_c, rtol=2e-4, atol=2e-5).all(axis=1)
    assert close.mean() >= 0.98, f"only {close.mean():.2%} of pixels agree"
    hit = np.asarray(want_t) < 1e29
    assert ((got_t.numpy() < 1e29) == hit).mean() >= 0.98


def test_engine_choice_matches_jax():
    """check_supported takes "bf16"; _use_bf16 is the JAX package's rule:
    bf16 asked for, bf16 tables present, at most GLO_SMEM_LIMIT groups."""
    jscene, _ = instanced_scene()
    scene = port_scene(jscene)
    cfg = port_config(SLICE_CFG)
    for prec in ("bf16", "f32"):
        tintegrator.check_supported(cfg.replace(leaf_precision=prec), scene)
    jdense = jscene.dense
    for n in (tb.GLO_SMEM_LIMIT, tb.GLO_SMEM_LIMIT + 1):
        rows = n * tdense.BF_ROWS
        jd = jdense._replace(groups_bf=np.broadcast_to(
            np.asarray(jdense.groups_bf)[:1, :1], (rows, 128)))
        td = tdense.DenseBVH(**{**scene.dense.__dict__,
                                "groups_bf": torch.zeros((1, 1), dtype=torch.bfloat16)
                                .expand(rows, 128)})
        for prec in ("bf16", "f32"):
            jcfg = SLICE_CFG.replace(leaf_precision=prec)
            assert tintegrator._use_bf16(port_config(jcfg), td) == \
                jintegrator._use_bf16(jcfg, jd), (n, prec)
    assert tintegrator._use_bf16(port_config(SLICE_CFG.replace(leaf_precision="bf16")),
                                 scene.dense)
    no_bf = tdense.DenseBVH(**{**scene.dense.__dict__, "groups_bf": None})
    assert not tintegrator._use_bf16(cfg.replace(leaf_precision="bf16"), no_bf)
    assert not jintegrator._use_bf16(SLICE_CFG.replace(leaf_precision="bf16"),
                                     jdense._replace(groups_bf=None))


def test_wrapper_counts_and_rejects(tables):
    """On the CPU the wrappers run the plain version (counted there, no
    launch); bad inputs and tables without bf16 leaves are refused."""
    _, td = tables["one-level"]
    o, d = _rays(64, seed=7)
    tb.reset_counts()
    tb.intersect_closest_bf16(td, T(o), T(d), refine="fast")
    tb.intersect_any_bf16(td, T(o), T(d), torch.ones(64))
    assert tb.PLAIN_CALLS == {"closest": 1, "any": 1}
    assert tb.LAUNCHES == {"closest": 0, "any": 0}
    with pytest.raises(TypeError):
        tb.intersect_any_bf16(td, T(o).double(), T(d), torch.ones(64))
    with pytest.raises(ValueError):
        tb.intersect_any_bf16(td, T(o), T(d), torch.ones(63))
    no_bf = tdense.DenseBVH(**{**td.__dict__, "groups_bf": None})
    with pytest.raises(ValueError, match="bf16"):
        tb.intersect_closest_bf16(no_bf, T(o), T(d))


@pytest.mark.cuda
def test_kernel_vs_plain_on_gpu(tables):
    """Kernel B2 vs its plain version on one- and two-level tables (runs
    where a GPU is present): the checks of chip_smoke.py phase 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    for level in ("one-level", "two-level"):
        td = tables[level][1].to(dev)
        o, d = _rays(4096, seed=8)
        o, d = T(o).to(dev), T(d).to(dev)
        for tm in (torch.full((4096,), 1e30, device=dev),
                   T(_tmax(o.cpu().numpy(), 9)).to(dev)):
            t_k, gk_k, i_k = tb._call_bf16(td, o, d, tm, closest=True)
            t_p, gk_p, i_p, near = tb.plain_traverse_bf16(td, o, d, tm, closest=True)
            out = ~near
            assert torch.equal((gk_k >= 0) & out, (gk_p >= 0) & out)
            assert bool((((gk_k == gk_p) & (i_k == i_p) & (t_k == t_p)) | near).all())
            cert_k, unc_k = tb._call_bf16(td, o, d, tm, closest=False)
            cert_p, unc_p, near_tm = tb.plain_traverse_bf16(td, o, d, tm, closest=False)
            assert torch.equal(cert_k & ~near_tm, cert_p & ~near_tm)
            assert torch.equal((unc_k & ~cert_k) & ~near_tm, (unc_p & ~cert_p) & ~near_tm)
    assert tb.truncated_rays(dev) == 0
