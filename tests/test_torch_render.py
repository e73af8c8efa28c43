"""The whole slice: the port's render_sample vs the JAX package's, same key,
and the port's one full-width integrator body (``trace_paths``, no host
gate) vs the JAX package's gated ``trace_paths`` on chunks of every kind:
lit, all dead after bounce 1 and all missed at bounce 0, on the dense, row
and lane engines.

Tolerance: at least 99% of pixels allclose at rtol=2e-4, atol=2e-5 and a
mean absolute image difference below 1e-3. The two integrators run the same
float32 operations, so most pixels agree to a few ulps; the slack covers
(a) ulp differences of sqrt/pow/sin/cos between XLA:CPU and PyTorch, which
the path throughput multiplies over the bounces, and (b) the rare path that
forks: a t-tie at a shared edge picked differently by the tile kernel and
the per-ray traversal, or a random number compared against a probability
that differs in its last bit (lobe choice, light pick), which moves that
pixel by a whole sample."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bench import build_bench_scene as jbuild_bench_scene  # noqa: E402
from physically_based_ray_tracer_tpu.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.render import integrator as jintegrator  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import render_sample as jrender  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu.scene.lights import LightSet as JLightSet  # noqa: E402
from physically_based_ray_tracer_tpu.scene.presets import cornell_box as jcornell_box  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_quad  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import MeshModel as JMeshModel  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import build_scene_instanced  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_rows, traverse  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import integrator as tintegrator  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import renderer as trenderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample as trender  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import profiling  # noqa: E402
from tests.scenes import sphere_scene  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

# the f32-engine config of tests/test_pallas_dense.py::test_integrator_pallas_matches_wave
SPHERE_CFG = RenderConfig(width=24, height=24, bounces=2, antialias=False,
                          skybox=False, accumulate=False, traversal="pallas",
                          leaf_precision="f32")


def _agree(got, want):
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5).all(axis=1)
    assert close.mean() >= 0.99, f"only {close.mean():.2%} of pixels agree"
    assert np.abs(got - want).mean() < 1e-3


@pytest.mark.parametrize("which", ["sphere", "instanced"])
def test_render_sample_matches_jax(which):
    if which == "sphere":
        jscene, jcam = sphere_scene()
        cfg = SPHERE_CFG
    else:
        jscene, jcam = instanced_scene()
        cfg = SLICE_CFG
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    want_c, want_t = jrender(jscene, jcam, cfg, jax.random.key(0), 0, jnp.asarray(ids))
    scene = port_scene(jscene)
    if which == "instanced":
        assert scene.dense.two_level
    trace.reset_counts()
    got_c, got_t = trender(scene, port_camera(jcam), port_config(cfg), 0, 0,
                           torch.from_numpy(ids))
    assert trace.PLAIN_CALLS["closest"] > 0 and trace.PLAIN_CALLS["any"] > 0
    want_c = np.asarray(want_c)
    assert want_c.mean() > 1e-3          # the image is not blank
    _agree(got_c.numpy(), want_c)
    hit = np.asarray(want_t) < 1e29
    np.testing.assert_array_equal(got_t.numpy() < 1e29, hit)
    np.testing.assert_allclose(got_t.numpy()[hit], np.asarray(want_t)[hit], rtol=1e-5)


def test_second_sample_matches_jax():
    """A later sample and another key draw other random streams."""
    jscene, jcam = instanced_scene()
    ids = np.arange(0, SLICE_CFG.n_pixels, 2, dtype=np.int32)
    want_c, _ = jrender(jscene, jcam, SLICE_CFG, jax.random.key(9), 3, jnp.asarray(ids))
    got_c, _ = trender(port_scene(jscene), port_camera(jcam), port_config(SLICE_CFG),
                       9, 3, torch.from_numpy(ids))
    _agree(got_c.numpy(), np.asarray(want_c))


def test_render_chunked_equals_one_chunk():
    """Chunking (with an edge-padded last chunk) changes no pixel."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    ids = torch.from_numpy(trenderer.morton_pixel_order(16, 16))
    cfg = port_config(SLICE_CFG)
    whole_c, whole_t = trenderer.render_chunked(scene, cam, cfg, 0, 0, ids)
    cfg = cfg.replace(chunk_pixels=100)      # 3 chunks of 86, last padded
    c, t = trenderer.render_chunked(scene, cam, cfg, 0, 0, ids)
    np.testing.assert_array_equal(c.numpy(), whole_c.numpy())
    np.testing.assert_array_equal(t.numpy(), whole_t.numpy())


def test_renderer_ticks_accumulate():
    """Renderer.tick == film update of render_chunked, in raster order."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(SLICE_CFG).replace(accumulate=True)
    r = trenderer.Renderer(scene, cam, cfg, device="cpu")
    img0 = r.tick(0)
    img1 = r.tick(0)
    assert img0.shape == (16, 16, 3) and np.isfinite(img1).all()
    ids = torch.from_numpy(trenderer.morton_pixel_order(16, 16))
    film = trenderer.film_mod.FilmState.zeros(256, device="cpu")
    for s in range(2):
        film, avg = trenderer.frame_fn(scene, cam, film, 0, s, ids, cfg=cfg)
    want = np.empty((256, 3), np.float32)
    want[ids.numpy()] = avg.numpy()
    np.testing.assert_array_equal(img1, np.clip(want.reshape(16, 16, 3), 0, 1))
    assert r.sample == 2
    r.reset_accumulation()
    assert r.sample == 0 and float(r.film.spp.sum()) == 0.0


# ---------------------------------------------------------------------------
# the one full-width body against the JAX package's gated trace_paths
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jbench(sky: bool = False):
    """The benchmark scene (``bench.py``; the port's
    ``presets.build_bench_scene``), with an 8x16 random sky image where
    ``sky``."""
    scene, cam, _ = jbuild_bench_scene()
    if sky:
        img = np.random.default_rng(5).random((8, 16, 3), dtype=np.float32)
        scene = scene._replace(sky=jnp.asarray(img))
    return scene, cam


@functools.lru_cache(maxsize=None)
def _jcornell():
    return jcornell_box()


@functools.lru_cache(maxsize=None)
def _jfloor(legacy_bvh: bool = False):
    """One floor quad under a camera looking straight down at it, lit by a
    point light: every primary ray hits it, and every bounce ray leaves
    upward into nothing (all lanes dead after bounce 1)."""
    floor = JMeshModel.from_fat(make_quad([-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4]),
                                base_color=(0.7, 0.7, 0.7), roughness=0.6)
    lights = JLightSet.make(point_pos=[[0.5, 3.0, 0.2]], point_color=[[9.0, 9.0, 9.0]])
    scene, _, _ = build_scene_instanced([floor], [JInstance(0)], lights,
                                        legacy_bvh=legacy_bvh, flatten=True)
    return scene, JCamera.make(pos=(0.0, 3.0, 0.01), target=(0.0, 0.0, 0.0))


BODY_CFG = RenderConfig(width=16, height=9, bounces=4, antialias=True, skybox=False,
                        one_shadow_ray=True)
EIGHT = {"width": 8, "height": 8}
# (JAX scene and camera, config changes, pixel ids): the top rows of the
# bench frame are sky, its middle rows spheres and floor
BODY_CASES = {
    "bench_bf16": (_jbench, {}, range(0, 144, 5)),
    "bench_f32": (_jbench, {"leaf_precision": "f32"}, range(0, 144, 5)),
    "cornell_bf16": (_jcornell, EIGHT, range(0, 64, 5)),
    "cornell_f32": (_jcornell, dict(EIGHT, leaf_precision="f32"), range(0, 64, 5)),
    "dead_after_bounce1": (_jfloor, EIGHT, range(0, 64, 3)),
    "all_miss": (_jbench, {}, range(0, 16)),
    "all_miss_sky": (lambda: _jbench(sky=True), {"skybox": True}, range(0, 16)),
    # engines whose full-width chunk never ran without the gates before
    "dead_after_bounce1_rows": (_jfloor, dict(EIGHT, traversal="pallas_rows"),
                                range(0, 64, 3)),
    "dead_after_bounce1_lane": (lambda: _jfloor(legacy_bvh=True),
                                dict(EIGHT, traversal="lane"), range(0, 64, 3)),
}
# bounces where the JAX package's full-width gates skip the shading block
# (no live lane hit anything) and the port runs it: a whole chunk dead
# after bounce 1, or missed at bounce 0
SKIPPED = {"dead_after_bounce1": 1, "all_miss": 0, "all_miss_sky": 0,
           "dead_after_bounce1_rows": 1, "dead_after_bounce1_lane": 1}


@pytest.mark.parametrize("case", BODY_CASES)
def test_one_body_matches_jax(case, monkeypatch):
    """The port's trace_paths runs every bounce's closest-hit pass and the
    whole shading block, with no host read, also from the bounce on which
    the JAX package's ``lax.cond`` gates skip them, and gives the JAX
    package's radiance and primary t (``_agree``; the hit masks equal, t
    within 1e-5 relative). A primary ray through a shared triangle edge may
    hit in one package and miss in the other (the floor's diagonal under
    the middle pixel: the JAX package's row and lane engines miss it, its
    B1 and the port's engines hit it); such a pixel must lie on an edge of
    the port's hit triangle, at most one per chunk, and is left out."""
    make, changes, ids = BODY_CASES[case]
    jscene, jcam = make()
    cfg = BODY_CFG.replace(**changes)
    tcfg = port_config(cfg)
    scene = port_scene(jscene, bvh=cfg.traversal == "lane")
    ids = torch.tensor(list(ids), dtype=torch.int32)
    xs = torch.remainder(ids, cfg.width).to(torch.float32)
    ys = torch.div(ids, cfg.width, rounding_mode="floor").to(torch.float32)
    o, d = primary_rays(port_camera(jcam), xs, ys, cfg.width, cfg.height)
    want_r, want_hit = jintegrator.trace_paths(jscene, cfg, jnp.asarray(o.numpy()),
                                               jnp.asarray(d.numpy()), jnp.asarray(ids.numpy()),
                                               jax.random.key(7), 2)
    passes, shaded = [], []
    real_closest, real_shade = tintegrator._closest, tintegrator._shade

    def closest(*a, **kw):
        passes.append(1)
        return real_closest(*a, **kw)

    def shade(scene, cfg, packs, lanes, *a, **kw):
        shaded.append(bool((lanes["alive_in"] & lanes["found0"]).any()))
        return real_shade(scene, cfg, packs, lanes, *a, **kw)
    monkeypatch.setattr(tintegrator, "_closest", closest)
    monkeypatch.setattr(tintegrator, "_shade", shade)
    for m in (trace, trace_rows, traverse):
        m.reset_counts()
    profiling.reset()
    got_r, got_hit = tintegrator.trace_paths(scene, tcfg, o, d, ids, 7, 2)
    assert len(passes) == len(shaded) == cfg.bounces and profiling.READS == {}
    if case in SKIPPED:
        first = SKIPPED[case]
        assert shaded == [True] * first + [False] * (cfg.bounces - first), shaded
    else:
        assert shaded[:2] == [True, True], shaded
    if cfg.traversal == "pallas_rows":
        assert trace_rows.PLAIN_CALLS["closest"] == cfg.bounces
    if cfg.traversal == "lane":
        assert sum(m.PLAIN_CALLS[k] for m in (trace, trace_rows) for k in m.PLAIN_CALLS) == 0
    got_r, got_t = got_r.numpy(), got_hit.t.numpy()
    want_r, want_t = np.asarray(want_r), np.asarray(want_hit.t)
    hit = want_t < 1e29
    fork = (got_t < 1e29) != hit
    if fork.any():
        exact = real_closest(scene, tcfg, o[fork], d[fork])
        w = torch.minimum(torch.minimum(exact.u, exact.v), 1.0 - exact.u - exact.v)
        assert fork.sum() == 1 and bool((exact.prim >= 0).all()) and float(w.abs().max()) < 1e-6
    _agree(got_r[~fork], want_r[~fork])
    keep = hit & ~fork
    np.testing.assert_allclose(got_t[keep], want_t[keep], rtol=1e-5)
    if case.startswith("all_miss"):
        assert not hit.any()
        assert bool((got_r > 0).all()) if case == "all_miss_sky" else not got_r.any()
    else:
        assert want_r.mean() > 1e-3
