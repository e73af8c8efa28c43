"""The whole slice: the port's render_sample vs the JAX package's, same key.

Tolerance: at least 99% of pixels allclose at rtol=2e-4, atol=2e-5 and a
mean absolute image difference below 1e-3. The two integrators run the same
float32 operations, so most pixels agree to a few ulps; the slack covers
(a) ulp differences of sqrt/pow/sin/cos between XLA:CPU and PyTorch, which
the path throughput multiplies over the bounces, and (b) the rare path that
forks: a t-tie at a shared edge picked differently by the tile kernel and
the per-ray traversal, or a random number compared against a probability
that differs in its last bit (lobe choice, light pick), which moves that
pixel by a whole sample."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import render_sample as jrender  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import renderer as trenderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample as trender  # noqa: E402
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
