"""The render options of the command-line path, the port's render_sample
against the JAX package's with the same key: sky radiance on missed lanes
(in the full-width block and in a slice's all-miss shortcut), the Panini
projection, the sub-tile shading gates, and the zero-contribution
shadow-ray pruning with a negative light colour (the AOV views:
tests/test_torch_aov.py).

Tolerances: whole-sample colours as tests/test_torch_render.py's
``_agree`` (>= 99% of pixels allclose at rtol 2e-4, atol 2e-5, mean
absolute difference < 1e-3: ulp differences of transcendental functions
that bounces multiply, and the rare path forked by a t-tie or a random
number compared with a probability that differs in its last bit); the
sub-tile gates change nothing: bit-equal to the full-width block."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.render import integrator as jintegrator  # noqa: E402
from physically_based_ray_tracer_tpu.scene.lights import LightSet as JLightSet  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import build_scene_instanced  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import integrator  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils.image import read_hdr  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import (SKY_FIXTURE, SLICE_CFG, instanced_parts,  # noqa: E402
                              instanced_scene, lone_sphere_scene, port_camera,
                              port_config, port_scene)

SKY = read_hdr(SKY_FIXTURE)


def _both(jscene, jcam, cfg, key=0, sample=0, ids=None):
    """(port, JAX) render_sample colours and primary t for the frame."""
    ids = np.arange(cfg.n_pixels, dtype=np.int32) if ids is None else ids
    want_c, want_t = jintegrator.render_sample(jscene, jcam, cfg, jax.random.key(key),
                                               sample, jnp.asarray(ids))
    got_c, got_t = integrator.render_sample(port_scene(jscene), port_camera(jcam),
                                            port_config(cfg), key, sample,
                                            torch.from_numpy(ids))
    return got_c.numpy(), np.asarray(want_c), got_t.numpy(), np.asarray(want_t)


class _Spy:
    """Counts the integrator's shading, all-miss and dead-slice branches."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in ("_shade", "_skip_shade", "_dead_skip"):
            self.calls[name] = 0
            monkeypatch.setattr(integrator, name, self._wrap(name, getattr(integrator, name)))

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return wrapped


@pytest.mark.parametrize("which", ["lone_sphere", "instanced"])
def test_sky_matches_jax(which, monkeypatch):
    """Sky radiance on missed lanes. The lone sphere, seen from outside,
    misses everything from bounce 1 on (every bounce ray leaves a convex
    surface), where the JAX package takes its all-miss shortcut and the
    port's full-width block runs as on every bounce; its sky must still be
    added there."""
    spy = _Spy(monkeypatch)
    if which == "lone_sphere":
        jscene, jcam = lone_sphere_scene(sky=SKY)
        cfg = SLICE_CFG.replace(skybox=True, bounces=3)
    else:
        jscene, jcam = instanced_scene(sky=SKY)
        cfg = SLICE_CFG.replace(skybox=True)
    got, want, got_t, want_t = _both(jscene, jcam, cfg)
    _agree(got, want)
    np.testing.assert_array_equal(got_t < 1e29, want_t < 1e29)
    if which == "lone_sphere":
        assert spy.calls == {"_shade": cfg.bounces, "_skip_shade": 0, "_dead_skip": 0}
    # the sky is really there: the same sample without it is darker
    dark, _ = integrator.render_sample(port_scene(jscene), port_camera(jcam),
                                       port_config(cfg.replace(skybox=False)), 0, 0,
                                       torch.arange(cfg.n_pixels, dtype=torch.int32))
    dark = dark.numpy()
    assert (got >= dark - 1e-6).all() and (got - dark).max() > 0.05


def test_sky_under_subtile_gates_matches_jax(monkeypatch):
    """shade_tile=16 on the instanced scene with a sky: slices of sky-only
    primary rays take the all-miss branch at bounce 0."""
    spy = _Spy(monkeypatch)
    jscene, jcam = instanced_scene(sky=SKY)
    cfg = SLICE_CFG.replace(skybox=True, shade_tile=16)
    got, want, _, _ = _both(jscene, jcam, cfg)
    _agree(got, want)
    assert spy.calls["_skip_shade"] > 0 and spy.calls["_shade"] > 0, spy.calls


def test_panini_render_sample_matches_jax():
    """post_processed=True casts the primary rays, both AA sub-rays,
    through the Panini projection of the camera's fov / distortion."""
    jscene, jcam = instanced_scene()
    jcam = jcam._replace(fov=jnp.float32(90.0), distortion=jnp.float32(2.0))
    cfg = SLICE_CFG.replace(post_processed=True, post_preset=1)
    got, want, _, _ = _both(jscene, jcam, cfg)
    _agree(got, want)
    plain, _ = integrator.render_sample(port_scene(jscene), port_camera(jcam),
                                        port_config(cfg.replace(post_processed=False)),
                                        0, 0, torch.arange(cfg.n_pixels, dtype=torch.int32))
    assert np.abs(got - plain.numpy()).max() > 0.05     # the projection changed the view


def test_shade_tile_matches_jax_and_full_width(monkeypatch):
    """shade_tile=16 (32 slices of 16 lanes of the AA-doubled 512-ray
    wavefront, each behind its own gates) against the JAX package, and
    bit-equal to the full-width block (the f32 engine is exact per ray)."""
    spy = _Spy(monkeypatch)
    jscene, jcam = instanced_scene()
    cfg = SLICE_CFG.replace(shade_tile=16)
    assert integrator._snap_subtiles(2 * cfg.n_pixels, 16) == 32
    got, want, got_t, want_t = _both(jscene, jcam, cfg)
    _agree(got, want)
    assert spy.calls["_shade"] > 32 and spy.calls["_dead_skip"] + spy.calls["_skip_shade"] > 0
    full, full_t = integrator.render_sample(port_scene(jscene), port_camera(jcam),
                                            port_config(SLICE_CFG), 0, 0,
                                            torch.arange(cfg.n_pixels, dtype=torch.int32))
    np.testing.assert_array_equal(got, full.numpy())
    np.testing.assert_array_equal(got_t, full_t.numpy())


@pytest.mark.parametrize("target", [0, 1, 7, 16, 64, 100, 4096])
def test_snap_subtiles_matches_jax(target):
    for B in [1, 2, 3, 16, 17, 96, 100, 256, 511, 512, 1000, 4096, 122880]:
        assert integrator._snap_subtiles(B, target) == jintegrator._snap_subtiles(B, target)


@pytest.mark.parametrize("one_shadow_ray", [True, False])
def test_negative_light_colour_matches_jax(one_shadow_ray):
    """The zero-contribution shadow-ray pruning (sum of the contribution
    not > 0 -> tmax 0, so never occluded) is kept for parity: a light with
    a negative colour component renders as the JAX package renders it."""
    models, instances, _, jcam = instanced_parts()
    lights = JLightSet.make(
        point_pos=[[2, 3, 2], [-2, 3, -1]], point_color=[[-30, 5, 5], [10, 12, 14]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, -4.0, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
    ).pad_points(4)
    jscene, _, _ = build_scene_instanced(models, instances, lights,
                                         legacy_bvh=False, flatten=False)
    cfg = SLICE_CFG.replace(one_shadow_ray=one_shadow_ray)
    got, want, _, _ = _both(jscene, jcam, cfg)
    _agree(got, want)
