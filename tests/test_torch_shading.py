"""Port shading modules vs the JAX package on the same numpy inputs.

Tolerance rtol=1e-5, atol=1e-6: both sides compute in float32 with the same
operation order; the residue is the last-bit difference of transcendental
functions (sqrt/pow/sin/cos/exp) between XLA:CPU and PyTorch's CPU kernels,
amplified at most a few ulps by the formulas that follow."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import (NDF, BRDFConfig, DiffuseModel,  # noqa: E402
                                                    RenderConfig, SpecularModel)
from physically_based_ray_tracer_tpu.ops import brdf as jbrdf  # noqa: E402
from physically_based_ray_tracer_tpu.ops.traverse import refine_hit as jrefine  # noqa: E402
from physically_based_ray_tracer_tpu.render import film as jfilm  # noqa: E402
from physically_based_ray_tracer_tpu.scene import material as jmat  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import primary_rays as jprimary  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import (Instance, MeshModel,  # noqa: E402
                                                         build_scene)
from physically_based_ray_tracer_tpu_torch.ops import brdf as tbrdf  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.traverse import refine_hit as trefine  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import film as tfilm  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import material as tmat  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays as tprimary  # noqa: E402
from tests.scenes import sphere_scene  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _unit(gen, n):
    v = gen.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _material(gen, n, mirror=False):
    f = lambda *s: gen.uniform(0.0, 1.0, s).astype(np.float32)
    metal = f(n)
    rough = f(n)
    if mirror:
        metal[: n // 4] = 1.0
        rough[: n // 4] = 0.0
    return dict(base_color=f(n, 3), metalness=metal, emissive=f(n, 3),
                roughness=rough, transmissivness=np.zeros(n, np.float32),
                reflectance=f(n), opacity=np.ones(n, np.float32))


def test_primary_rays():
    _, jcam = sphere_scene()
    gen = np.random.default_rng(0)
    xs = gen.uniform(0, 64, 500).astype(np.float32)
    ys = gen.uniform(0, 48, 500).astype(np.float32)
    jo, jd = jprimary(jcam, jnp.asarray(xs), jnp.asarray(ys), 64, 48)
    to, td = tprimary(port_camera(jcam), torch.from_numpy(xs),
                      torch.from_numpy(ys), 64, 48)
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("seed", [0, 1])
def test_brdf_default_config(seed):
    gen = np.random.default_rng(seed)
    n = 2000
    nrm, l, v = _unit(gen, n), _unit(gen, n), _unit(gen, n)
    flip = (nrm * v).sum(1) < 0
    v[flip] = -v[flip]
    m = _material(gen, n, mirror=True)
    jm = jbrdf.MaterialProperties(**{k: jnp.asarray(x) for k, x in m.items()})
    tm = tbrdf.MaterialProperties(**{k: torch.from_numpy(x) for k, x in m.items()})
    J = lambda x: jnp.asarray(x)
    T = torch.from_numpy
    _close(tbrdf.eval_combined_brdf(T(nrm), T(l), T(v), tm),
           jbrdf.eval_combined_brdf(J(nrm), J(l), J(v), jm))
    _close(tbrdf.get_brdf_probability(tm, T(v), T(nrm)),
           jbrdf.get_brdf_probability(jm, J(v), J(nrm)))
    u2 = gen.uniform(0, 1, (n, 2)).astype(np.float32)
    btype = gen.integers(1, 3, n).astype(np.int32)
    jd, jw, jv = jbrdf.eval_indirect_combined_brdf(J(u2), J(nrm), J(nrm), J(v), jm,
                                                   J(btype), BRDFConfig())
    td, tw, tv = tbrdf.eval_indirect_combined_brdf(T(u2), T(nrm), T(nrm), T(v), tm,
                                                   T(btype), port_config(BRDFConfig()))
    # The VNDF sample computes sqrt(1 - p1^2 - p2^2), which cancels as
    # u -> 1 and there amplifies the 1-ulp differences between XLA's and
    # PyTorch's sqrt/sin/cos (measured: ~1 lane in 2000 at 2e-5 relative).
    # So: the stated tolerance on all but 0.1% of lanes, and every lane
    # within 1e-4 relative.
    for got, want in ((td, jd), (tw, jw)):
        got, want = got.numpy(), np.asarray(want)
        off = ~np.isclose(got, want, **TOL).all(axis=1)
        assert off.mean() <= 1e-3, f"{off.sum()} lanes off"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


BRDF_MATRIX = [
    dict(ndf=NDF.BECKMANN, use_optimized_g2=False),
    dict(use_vndf_sampling=False),
    dict(use_spherical_caps_vndf=True),
    dict(use_height_correlated_g2=False),
    dict(use_optimized_g2=False),
    dict(use_reflectance_parameter=True),
    dict(combine_brdfs_with_fresnel=False),
    dict(specular=SpecularModel.PHONG),
    dict(specular=SpecularModel.NONE),
    dict(diffuse=DiffuseModel.NONE),
    dict(diffuse=DiffuseModel.OREN_NAYAR),
    dict(diffuse=DiffuseModel.DISNEY),
    dict(diffuse=DiffuseModel.FROSTBITE),
]


@pytest.mark.parametrize("kw", BRDF_MATRIX, ids=lambda kw: "-".join(
    f"{k}={getattr(v, 'name', v)}" for k, v in kw.items()))
def test_brdf_config_matrix(kw):
    """The non-default BRDFConfig branches, ported elementwise."""
    cfg = BRDFConfig(**kw)
    gen = np.random.default_rng(7)
    n = 1000
    nrm, l, v = _unit(gen, n), _unit(gen, n), _unit(gen, n)
    flip = (nrm * v).sum(1) < 0
    v[flip] = -v[flip]
    m = _material(gen, n)
    m["roughness"] = np.clip(m["roughness"], 0.05, 1.0)
    jm = jbrdf.MaterialProperties(**{k: jnp.asarray(x) for k, x in m.items()})
    tm = tbrdf.MaterialProperties(**{k: torch.from_numpy(x) for k, x in m.items()})
    J, T = jnp.asarray, torch.from_numpy
    want = np.asarray(jbrdf.eval_combined_brdf(J(nrm), J(l), J(v), jm, cfg))
    got = tbrdf.eval_combined_brdf(T(nrm), T(l), T(v), tm, port_config(cfg)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    u2 = gen.uniform(0, 0.999, (n, 2)).astype(np.float32)
    btype = gen.integers(1, 3, n).astype(np.int32)
    jd, jw, _ = jbrdf.eval_indirect_combined_brdf(J(u2), J(nrm), J(nrm), J(v), jm,
                                                  J(btype), cfg)
    td, tw, _ = tbrdf.eval_indirect_combined_brdf(T(u2), T(nrm), T(nrm), T(v), tm,
                                                  T(btype), port_config(cfg))
    for got, want in ((td, jd), (tw, jw)):
        got, want = got.numpy(), np.asarray(want)
        off = ~np.isclose(got, want, **TOL).all(axis=1)
        assert off.mean() <= 1e-3, f"{off.sum()} lanes off"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _textured_scene():
    """Sphere with albedo/normal/RMA/emission textures + untextured floor."""
    gen = np.random.default_rng(3)
    tex = lambda h, w: gen.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32)
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=6, lon=8),
                                albedo_texture=tex(8, 16), normal_texture=tex(4, 4),
                                rma_texture=tex(5, 7), emission_texture=tex(3, 9))
    floor = MeshModel.from_fat(make_quad([-3, -1, -3], [3, -1, -3], [3, -1, 3],
                                         [-3, -1, 3]), metalness=0.3)
    scene, _ = build_scene([sphere, floor], [Instance(0), Instance(1)])
    return scene


@pytest.mark.parametrize("normal_mapped", [True, False])
def test_material_and_shading_normal_packed(normal_mapped):
    jscene = _textured_scene()
    tscene = port_scene(jscene)
    gen = np.random.default_rng(4)
    n = 1500
    prim = gen.integers(0, jscene.tri_v0.shape[0], n).astype(np.int32)
    uv = gen.uniform(0, 1, (n, 2)).astype(np.float32)
    uv[uv.sum(1) > 1] *= 0.5
    u, v = uv[:, 0], uv[:, 1]
    ja = jmat.gather_hit_attrs(jscene, jmat.packed_tables(jscene), jnp.asarray(prim))
    ta = tmat.gather_hit_attrs(tscene, tmat.packed_tables(tscene),
                               torch.from_numpy(prim).long())
    for k in ja:
        _close(ta[k], ja[k])
    _close(tmat.shading_normal_packed(tscene, ta, torch.from_numpy(u),
                                      torch.from_numpy(v), normal_mapped),
           jmat.shading_normal_packed(jscene, ja, jnp.asarray(u), jnp.asarray(v),
                                      normal_mapped))
    tm = tmat.material_packed(tscene, ta, torch.from_numpy(u), torch.from_numpy(v))
    jm = jmat.material_packed(jscene, ja, jnp.asarray(u), jnp.asarray(v))
    for got, want in zip(tm, jm):
        _close(got, want)


def test_small_helpers():
    """safe_rcp (zero-protected reciprocal, exact) and walters_trick."""
    from physically_based_ray_tracer_tpu.ops.intersect import safe_rcp as jrcp
    from physically_based_ray_tracer_tpu.ops.sampling import walters_trick as jwt
    from physically_based_ray_tracer_tpu_torch.ops.intersect import safe_rcp as trcp
    from physically_based_ray_tracer_tpu_torch.ops.sampling import walters_trick as twt
    gen = np.random.default_rng(8)
    x = np.concatenate([gen.normal(size=500), [0.0, -0.0, 1e-21, -1e-21, 1e-19]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(trcp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jrcp(jnp.asarray(x))))
    a, n = gen.uniform(0, 1, 500).astype(np.float32), gen.normal(size=500).astype(np.float32)
    _close(twt(torch.from_numpy(a), torch.from_numpy(n)), jwt(jnp.asarray(a), jnp.asarray(n)))


def test_refine_hit():
    """Rays aimed at a known point of their triangle, as the integrator
    refines them; 20% of the lanes are masked off as misses."""
    gen = np.random.default_rng(5)
    n = 1000
    f = lambda *s: gen.normal(size=s).astype(np.float32)
    d, v0, e1, e2 = f(n, 3), f(n, 3), f(n, 3), f(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    uv = gen.uniform(0, 1, (n, 2)).astype(np.float32)
    flip = uv.sum(1) > 1
    uv[flip] = 1 - uv[flip]
    t = gen.uniform(0.5, 5.0, n).astype(np.float32)
    o = (v0 + uv[:, :1] * e1 + uv[:, 1:] * e2 - t[:, None] * d).astype(np.float32)
    mask = gen.uniform(size=n) < 0.8
    J = jnp.asarray
    T = torch.from_numpy
    for got, want in zip(trefine(T(o), T(d), T(v0), T(e1), T(e2), T(mask)),
                         jrefine(J(o), J(d), J(v0), J(e1), J(e2), J(mask))):
        _close(got, want)


@pytest.mark.parametrize("kw", [{}, dict(gamma_corrected=False),
                                dict(accumulate=False),
                                dict(depth_keyed_accum=False)])
def test_film_update(kw):
    cfg = RenderConfig(**kw)
    gen = np.random.default_rng(6)
    n = 777
    accum = gen.uniform(0, 3, (n, 3)).astype(np.float32)
    spp = gen.integers(0, 5, n).astype(np.float32)
    dist = gen.uniform(0, 10, n).astype(np.float32)
    color = gen.uniform(-0.1, 2, (n, 3)).astype(np.float32)
    t = np.where(gen.uniform(size=n) < 0.5, dist + 0.001, dist + 1).astype(np.float32)
    jf, javg = jfilm.update(jfilm.FilmState(jnp.asarray(accum), jnp.asarray(spp),
                                            jnp.asarray(dist)),
                            jnp.asarray(color), jnp.asarray(t), cfg)
    tf, tavg = tfilm.update(tfilm.FilmState(torch.from_numpy(accum),
                                            torch.from_numpy(spp),
                                            torch.from_numpy(dist)),
                            torch.from_numpy(color), torch.from_numpy(t),
                            port_config(cfg))
    _close(tavg, javg)
    for got, want in zip(tf, jf):
        _close(got, want)
