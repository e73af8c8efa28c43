"""The AOV views (``rendering_mode`` other than BRDF): the port's
render_sample against the JAX package's, every mode with the bf16 engine
(its unsorted closest-hit pass with the exact refine, which the bounces
never take) and with the exact f32 engine.

The JAX package's closest-hit pass on the frame's primary rays is computed
once per engine (its Pallas kernel runs in interpret mode, seconds a call)
and handed to its ``render_aov`` for each mode; the port runs its own pass
every time.

Tolerance: one closest-hit pass and elementwise shading, so per pixel at
rtol 1e-5 / atol 1e-6, on every pixel with the bf16 engine (its CPU path
breaks near-ties across leaf groups as the reference kernel's tile walk
does) and on >= 99% of pixels with the f32 engine (an exact t-tie at a
shared edge is broken per ray: another triangle, another colour). DEPTH is
normalised by the frame's largest hit distance on both sides, PRIMID is the
same 32-bit hash."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderMode  # noqa: E402
from physically_based_ray_tracer_tpu.render import integrator as jintegrator  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import primary_rays as jprimary_rays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import integrator  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

AOV_CFG = SLICE_CFG.replace(width=24, height=24)
MODES = [m for m in RenderMode if m != RenderMode.BRDF]


@functools.lru_cache(maxsize=None)
def _scene():
    jscene, jcam = instanced_scene()
    return jscene, jcam, port_scene(jscene), port_camera(jcam)


@functools.lru_cache(maxsize=None)
def _jax_hit(leaf_precision):
    """The JAX package's closest-hit pass of render_aov on the frame."""
    jscene, jcam, _, _ = _scene()
    cfg = AOV_CFG.replace(leaf_precision=leaf_precision)
    ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    o, d = jprimary_rays(jcam, (ids % cfg.width).astype(jnp.float32),
                         (ids // cfg.width).astype(jnp.float32), cfg.width, cfg.height)
    return jintegrator._closest(jintegrator.Accel(jscene.bvh, jscene.dense), cfg, o, d)


@pytest.mark.parametrize("leaf_precision", ["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_render_aov_matches_jax(mode, leaf_precision, monkeypatch):
    jscene, jcam, scene, cam = _scene()
    cfg = AOV_CFG.replace(rendering_mode=mode, leaf_precision=leaf_precision)
    hit = _jax_hit(leaf_precision)
    monkeypatch.setattr(jintegrator, "_closest", lambda *a, **kw: hit)
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    want, want_t = jintegrator.render_sample(jscene, jcam, cfg, jax.random.key(0), 0,
                                             jnp.asarray(ids))
    want, want_t = np.asarray(want), np.asarray(want_t)
    trace.reset_counts()
    trace_bf16.reset_counts()
    got, got_t = integrator.render_sample(scene, cam, port_config(cfg), 0, 0,
                                          torch.from_numpy(ids))
    got, got_t = got.numpy(), got_t.numpy()
    engine = trace_bf16 if leaf_precision == "bf16" else trace
    assert engine.PLAIN_CALLS == {"closest": 1, "any": 0}     # one unsorted pass
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(axis=1)
    need = 1.0 if leaf_precision == "bf16" else 0.99
    assert close.mean() >= need, f"{close.mean():.4f} of pixels agree"
    hit = want_t < 1e29
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got_t < 1e29, hit)
    assert (got[~hit] == 0).all()
    if mode == RenderMode.DEPTH:
        assert np.isclose(got.max(), 1.0)
    else:
        assert got[hit].max() > 0.05 or mode in (RenderMode.EMMISIVE, RenderMode.METAL)
