"""The port's Renderer against the JAX package's at image level: in-frame
samples (``samples_per_pixel``), post-processing presets (the Panini
projection of the preset's fov / distortion, aberration, grading,
vignette), PNG capture, the film's current image, frame stats and the ray
count; and the timing helpers.

Tolerance: images as tests/test_torch_render.py's ``_agree`` on the
flattened (H*W, 3) image (>= 99% of pixels allclose at rtol 2e-4, atol
2e-5, mean absolute difference < 1e-3); the ray count exactly."""

import dataclasses
import functools
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.ops.tonemap import POST_PRESETS as JPOST  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu.utils import image as jimage  # noqa: E402
from physically_based_ray_tracer_tpu.utils import timer as jtimer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops.tonemap import POST_PRESETS  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import renderer as trenderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import image as timage  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import timer as ttimer  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

ACC_CFG = SLICE_CFG.replace(accumulate=True)


def _post_camera(jcam, preset):
    pp = JPOST[preset]
    return jcam._replace(fov=jnp.float32(pp["fov"]), distortion=jnp.float32(pp["distortion"]))


@functools.lru_cache(maxsize=None)
def _jax_image(cfg, preset_cam=None):
    """Two ticks of the JAX Renderer (key 0), the second's image."""
    jscene, jcam = instanced_scene()
    if preset_cam is not None:
        jcam = _post_camera(jcam, preset_cam)
    r = JRenderer(jscene, jcam, cfg)
    r.tick()
    return r.tick(), r.stats.rays


def _port_renderer(cfg, preset_cam=None):
    jscene, jcam = instanced_scene()
    if preset_cam is not None:
        jcam = _post_camera(jcam, preset_cam)
    return Renderer(port_scene(jscene), port_camera(jcam), port_config(cfg), device="cpu")


def _flat(img):
    return img.reshape(-1, 3)


@pytest.mark.parametrize("spp", [2, 3])
def test_samples_per_pixel_matches_jax(spp):
    cfg = ACC_CFG.replace(samples_per_pixel=spp)
    want, _ = _jax_image(cfg)
    r = _port_renderer(cfg)
    r.tick(0)
    got = r.tick(0)
    _agree(_flat(got), _flat(want))
    assert r.sample == 2 and float(r.film.spp.max()) == 2.0


def test_render_spp_is_the_mean_of_its_samples():
    """_render_spp averages samples sample*spp + s; its primary t is
    sample 0's."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(SLICE_CFG.replace(samples_per_pixel=2))
    ids = torch.arange(0, 256, 3, dtype=torch.int32)
    c, t = trenderer._render_spp(scene, cam, cfg, 5, 1, ids)
    one = cfg.replace(samples_per_pixel=1)
    c2, t2 = trenderer.render_sample(scene, cam, one, 5, 2, ids)
    c3, _ = trenderer.render_sample(scene, cam, one, 5, 3, ids)
    np.testing.assert_array_equal(c.numpy(), ((c2 + c3) / 2).numpy())
    np.testing.assert_array_equal(t.numpy(), t2.numpy())


@pytest.mark.parametrize("preset", [1, 2])
def test_post_processed_matches_jax(preset):
    """post_processed with a named preset, the camera's fov / distortion
    set from it as the command line sets them."""
    cfg = ACC_CFG.replace(post_processed=True, post_preset=preset)
    want, _ = _jax_image(cfg, preset)
    r = _port_renderer(cfg, preset)
    r.tick(0)
    got = r.tick(0)
    _agree(_flat(got), _flat(want))
    # the post chain ran: the corners are darker than without it
    plain = _port_renderer(cfg.replace(post_processed=False), preset).render(2)
    assert got[0, 0].sum() < plain[0, 0].sum() or plain[0, 0].sum() == 0


def test_unknown_post_preset_takes_preset_2():
    """POST_PRESETS.get(post_preset, POST_PRESETS[2]), as in the JAX package."""
    assert POST_PRESETS == JPOST
    base = _port_renderer(ACC_CFG.replace(post_processed=True, post_preset=2))
    other = _port_renderer(ACC_CFG.replace(post_processed=True, post_preset=7))
    np.testing.assert_array_equal(base.render(1), other.render(1))


def test_capture_roundtrip(tmp_path):
    """capture renders a frame first when none was rendered, writes the
    PNG, and the file reads back as the 8-bit image; the bytes equal the
    JAX package's writer's for the same image."""
    r = _port_renderer(ACC_CFG)
    path = r.capture(str(tmp_path / "a" / "cap.png"))
    assert r.sample == 1
    img = r._current_image()
    back = timage.read_image(path)[..., :3]
    np.testing.assert_array_equal(back, timage.rgbf32_to_rgb8(img).astype(np.float32) / 255.0)
    jpath = jimage.write_png(str(tmp_path / "j.png"), img)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    r.tick(0)
    path2 = r.capture(str(tmp_path / "cap2.png"))
    assert r.sample == 2 and path2.endswith("cap2.png")


def test_write_png_without_pil_writes_ppm(tmp_path, monkeypatch):
    """Without PIL both packages write an uncompressed PPM under the .png
    name, byte for byte the same."""
    img = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "PIL", None)
    p = timage.write_png(str(tmp_path / "x.png"), img)
    q = jimage.write_png(str(tmp_path / "y.png"), img)
    data = open(p, "rb").read()
    assert data.startswith(b"P6\n7 5\n255\n") and data == open(q, "rb").read()


def test_current_image_is_the_film_mean():
    """_current_image == the last tick's image (the film's running mean),
    post-processed like it."""
    for cfg in (ACC_CFG, ACC_CFG.replace(post_processed=True)):
        r = _port_renderer(cfg)
        r.tick(0)
        img = r.tick(0)
        np.testing.assert_allclose(r._current_image(), img, rtol=1e-6, atol=1e-7)


def test_stats_match_jax():
    """Renderer.stats after a tick: the ray count equals the JAX Renderer's,
    a positive frame time, the EMA schedule of FrameStats."""
    _, want_rays = _jax_image(ACC_CFG.replace(samples_per_pixel=2))
    r = _port_renderer(ACC_CFG.replace(samples_per_pixel=2))
    r.tick(0)
    assert r.stats.rays == want_rays
    assert r.stats.frame_ms > 0 and r.stats.ema_ms == r.stats.frame_ms
    assert r.stats.mrays_per_s > 0 and r.stats.fps > 0
    first = r.stats.frame_ms
    r.tick(0)
    assert r.stats.ema_ms == pytest.approx(0.5 * first + 0.5 * r.stats.frame_ms)


@pytest.mark.parametrize("kw", [
    {}, dict(antialias=False), dict(lighted=False), dict(stochastic_lights=False),
    dict(one_shadow_ray=False), dict(bounces=4, antialias=False)],
    ids=lambda kw: ",".join(kw) or "default")
def test_ray_count_matches_jax(kw):
    cfg = SLICE_CFG.replace(**kw)
    for n_point in (0, 1, 4):
        for spp in (1, 3):
            assert (ttimer.ray_count(port_config(cfg), cfg.n_pixels, spp, n_point)
                    == jtimer.ray_count(cfg, cfg.n_pixels, spp, n_point))


def test_frame_stats_and_timers():
    s, j = ttimer.FrameStats(), jtimer.FrameStats()
    for ms, rays in ((12.0, 1000), (8.0, 2000), (10.0, 1500)):
        s.update(ms, rays)
        j.update(ms, rays)
    assert dataclasses.asdict(s) == dataclasses.asdict(j)
    assert s.fps == j.fps and s.mrays_per_s == j.mrays_per_s
    with ttimer.DeviceTimer("cpu") as t:
        torch.ones(1000).sum()
    assert t.ms > 0
    assert ttimer.time_fn(lambda x: x * 2, torch.ones(8), warmup=1, iters=3) >= 0
