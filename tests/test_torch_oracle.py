"""The port's image against the float64 numpy oracle (tests/oracle.py): the
counterparts of tests/test_parity.py (the deterministic directional config,
image and AOV hit mask) and tests/test_parity_stochastic.py (glass, mirror,
point, spot and directional lights, dielectric RR, lobe RIS, every lottery
branch), on their scenes and sizes, under their tolerance policy.

The stochastic oracle consumes the port's own Purpose-stream uniforms, which
must equal the JAX package's bit for bit. Each scene's port image is also
held to the JAX one by tests/test_torch_render.py::_agree."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig, RenderMode  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import trace_paths as jtrace_paths  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import primary_rays as jprimary  # noqa: E402
from physically_based_ray_tracer_tpu.utils import rng as jrng  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace_bf16  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import trace_paths  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import rng  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils.rng import Purpose  # noqa: E402
from tests import oracle, test_parity, test_parity_stochastic  # noqa: E402
from tests.test_torch_golden import _same_scene  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

PURPOSES = ("LIGHT_TYPE", "LIGHT_SELECT", "LOBE_SELECT", "DIELECTRIC")
STOCH_KEY = 7
STOCH_CFG = RenderConfig(width=test_parity_stochastic.W, height=test_parity_stochastic.H,
                         bounces=test_parity_stochastic.BOUNCES, antialias=False,
                         skybox=False, stochastic_lights=True, one_shadow_ray=True,
                         max_stack_depth=24)


@pytest.fixture(scope="module")
def directional():
    """tests/test_parity.py's scene, oracle image and oracle hit mask."""
    jscene, jcam, ref, hitmask = test_parity.setup.__wrapped__()
    return jscene, jcam, port_scene(jscene), port_camera(jcam), ref, hitmask


@pytest.fixture(scope="module")
def stochastic():
    jscene, jcam = test_parity_stochastic.setup.__wrapped__()
    return jscene, jcam, port_scene(jscene), port_camera(jcam)


def test_image_allclose_to_oracle(directional):
    jscene, jcam, scene, cam, ref, _ = directional
    trace_bf16.reset_counts()
    img = Renderer(scene, cam, port_config(test_parity.CFG), device="cpu").tick(0)
    # the config's engine is the default one (bf16)
    assert trace_bf16.PLAIN_CALLS["closest"] > 0 and trace_bf16.PLAIN_CALLS["any"] > 0
    # tests/test_parity.py's policy: f32 vs f64, epsilon-offset shadow rays
    # at silhouettes may move a few boundary pixels, the rest tight
    diff = np.abs(img - ref)
    frac_loose = (diff.max(axis=-1) > 2e-3).mean()
    assert frac_loose < 0.02, f"{frac_loose:.3%} pixels off, max diff {diff.max():.4f}"
    assert np.median(diff) < 2e-4
    want = JRenderer(jscene, jcam, test_parity.CFG).tick(jax.random.key(0))
    _agree(img.reshape(-1, 3), want.reshape(-1, 3))


def test_aov_depth_matches_oracle_hits(directional):
    jscene, jcam, scene, cam, _, hitmask = directional
    cfg = test_parity.CFG.replace(rendering_mode=RenderMode.BASECOLOR,
                                  gamma_corrected=False)
    img = Renderer(scene, cam, port_config(cfg), device="cpu").tick()
    aov = img.sum(axis=-1) > 0
    agree = (hitmask == aov).mean()
    assert agree > 0.97, f"hit masks agree only {agree:.3%}"
    want = JRenderer(jscene, jcam, cfg).tick()
    _agree(img.reshape(-1, 3), want.reshape(-1, 3))


def _stochastic_rays(cam, w, h):
    ids = torch.arange(w * h, dtype=torch.int32)
    o, d = primary_rays(cam, (ids % w).float(), (ids // w).float(), w, h)
    return ids, o, d


def _draws(ids, bounces):
    """The Purpose-stream uniforms the port's integrator consumes."""
    out = []
    for b in range(bounces):
        u = {k: rng.uniform1(STOCH_KEY, ids, 0, b, getattr(Purpose, k)).double().numpy()
             for k in PURPOSES}
        u["BRDF_SAMPLE"] = rng.uniform2(STOCH_KEY, ids, 0, b,
                                        Purpose.BRDF_SAMPLE).double().numpy()
        out.append(u)
    return out


def test_stochastic_paths_match_oracle(stochastic):
    jscene, jcam, scene, cam = stochastic
    w = h = test_parity_stochastic.W
    bounces = test_parity_stochastic.BOUNCES
    jcfg = STOCH_CFG
    ids, o, d = _stochastic_rays(cam, w, h)
    rad, _ = trace_paths(scene, port_config(jcfg), o, d, ids, STOCH_KEY, 0)
    rad = rad.double().numpy()

    # the port's draws are the JAX integrator's, bit for bit
    draws = _draws(ids, bounces)
    jids = jnp.asarray(ids.numpy())
    jkey = jax.random.key(STOCH_KEY)
    for b in range(bounces):
        for k in PURPOSES:
            want = jrng.uniform1(jkey, jids, 0, b, getattr(jrng.Purpose, k))
            np.testing.assert_array_equal(draws[b][k], np.asarray(want, float))
        want = jrng.uniform2(jkey, jids, 0, b, jrng.Purpose.BRDF_SAMPLE)
        np.testing.assert_array_equal(draws[b]["BRDF_SAMPLE"], np.asarray(want, float))

    osc = test_parity_stochastic._oracle_scene(jscene)
    o_np, d_np = o.double().numpy(), d.double().numpy()
    rel = np.zeros(w * h)
    for p in range(w * h):
        pd = [dict(u_type=draws[b]["LIGHT_TYPE"][p], u_sel=draws[b]["LIGHT_SELECT"][p],
                   u_lobe=draws[b]["LOBE_SELECT"][p], u_diel=draws[b]["DIELECTRIC"][p],
                   u2=draws[b]["BRDF_SAMPLE"][p]) for b in range(bounces)]
        ref = oracle.trace_path_stochastic(o_np[p], d_np[p], osc, pd, bounces)
        rel[p] = np.max(np.abs(ref - rad[p])) / max(np.max(np.abs(ref)), 1.0)
    # tests/test_parity_stochastic.py's policy: float32 BRDF-sample
    # directions diverge chaotically from float64 after a bounce near
    # silhouettes, so a small outlier share; the median tight
    frac_loose = (rel > 2e-3).mean()
    assert frac_loose < 0.05, (
        f"{frac_loose:.3%} pixels disagree with the float64 oracle "
        f"(max rel {rel.max():.4f})")
    assert np.median(rel) < 2e-4, f"median rel diff {np.median(rel):.2e}"

    jo, jd = jprimary(jcam, jnp.asarray((ids % w).numpy(), jnp.float32),
                      jnp.asarray((ids // w).numpy(), jnp.float32), w, h)
    want, _ = jtrace_paths(jscene, jcfg, jo, jd, jids, jkey, sample=0)
    _agree(rad, np.asarray(want, float))


def test_stochastic_covers_all_lottery_branches(stochastic):
    """The port's light-type draws at bounce 0 pick point, directional and
    spot lights on this pixel set (guards against a vacuous parity pass)."""
    _, _, _, cam = stochastic
    w = h = test_parity_stochastic.W
    ids, _, _ = _stochastic_rays(cam, w, h)
    u = _draws(ids, 1)[0]["LIGHT_TYPE"]
    assert (u < 0.3).any() and ((u >= 0.3) & (u < 0.8)).any() and (u >= 0.8).any()


@pytest.mark.parametrize("which", ["directional", "stochastic"])
def test_chip_smoke_renders_these_scenes(which, directional, stochastic):
    """chip_smoke.py phase 17b builds these scenes with the port (it imports
    no JAX): every table equal to the JAX build's, byte for byte, the same
    camera and configs."""
    import chip_smoke

    jscene, jcam = (directional if which == "directional" else stochastic)[:2]
    scene, cam = chip_smoke.parity_scenes("cpu")[which]
    _same_scene(scene, jscene)
    for a, b in ((cam.pos, jcam.pos), (cam.target, jcam.target)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfgs = chip_smoke.parity_configs()
    assert cfgs["directional"] == port_config(test_parity.CFG)
    assert cfgs["stochastic"] == port_config(STOCH_CFG)
    assert (cfgs["stochastic"].width, chip_smoke.STOCH_KEY) == (test_parity_stochastic.W,
                                                                 STOCH_KEY)
