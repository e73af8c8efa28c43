"""The BRDFConfig matrix at image level: the port's Renderer vs the JAX
package's on tests/test_parity_stochastic.py's scene (a rough sphere, a glass
sphere, a mirror sphere, an emissive floor, point, spot and directional
lights), one tick, f32 engine, 24x24, 3 bounces, AA off, key 0, under the
default BRDFConfig and each of tests/test_torch_shading.py's BRDF_MATRIX.

Tolerance: tests/test_torch_render.py::_agree (>= 99% of pixels allclose at
rtol 2e-4, atol 2e-5, mean abs difference < 1e-3). Each case forks one pixel
of 576: the primary ray of pixel (6, 12) passes through the rough sphere's
pole, a vertex of two triangles whose t differ by 1e-6 relative; the port's
per-ray walk takes the nearer (as float64 brute force does), the JAX
frame's takes the other one.

Every setting that changes the model must also move the image: more than 1%
of its pixels outside that tolerance of the default image, so that a branch
the renderer ignored could not pass as parity."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from physically_based_ray_tracer_tpu.config import BRDFConfig, RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch import config as tconfig  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from tests import test_parity_stochastic  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.test_torch_shading import BRDF_MATRIX  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

CFG = RenderConfig(width=24, height=24, bounces=3, antialias=False, skybox=False,
                   traversal="pallas", leaf_precision="f32", one_shadow_ray=True,
                   max_stack_depth=24)
CASES = [{}] + BRDF_MATRIX

# Settings that select another form of the same function, exempt from
# moving the image (they must instead keep it, by _agree):
# use_optimized_g2=False with GGX evaluates the textbook height-correlated
# Smith G2 and divides it by 4 NdotL NdotV, where the default evaluates
# Lagarde's form of that quotient (Core/BRDF.cpp:189-208); the two differ
# only in rounding.
EQUIVALENT = ({"use_optimized_g2": False},)


def _name(kw):
    return "-".join(f"{k}={getattr(v, 'name', v)}" for k, v in kw.items()) or "default"


@pytest.fixture(scope="module")
def scenes():
    jscene, jcam = test_parity_stochastic.setup.__wrapped__()
    return jscene, jcam, port_scene(jscene), port_camera(jcam)


@pytest.fixture(scope="module")
def default_image(scenes):
    _, _, scene, cam = scenes
    return Renderer(scene, cam, port_config(CFG), device="cpu").tick(0)


@pytest.mark.parametrize("kw", CASES, ids=_name)
def test_brdf_config_image_matches_jax(kw, scenes, default_image):
    jscene, jcam, scene, cam = scenes
    cfg = CFG.replace(brdf=BRDFConfig(**kw))
    want = JRenderer(jscene, jcam, cfg).tick(jax.random.key(0))
    trace.reset_counts()
    got = Renderer(scene, cam, port_config(cfg), device="cpu").tick(0)
    assert trace.PLAIN_CALLS["closest"] > 0 and trace.PLAIN_CALLS["any"] > 0
    assert got.shape == (24, 24, 3) and want.mean() > 1e-2
    _agree(got.reshape(-1, 3), want.reshape(-1, 3))
    moved = np.abs(got - default_image).mean()
    off = ~np.isclose(got, default_image, rtol=2e-4, atol=2e-5).all(axis=-1)
    print(f"{_name(kw)}: mean abs difference from the default image {moved:.6g}, "
          f"{off.mean():.2%} of pixels off")
    if not kw:
        np.testing.assert_array_equal(got, default_image)
    elif kw in EQUIVALENT:
        _agree(got.reshape(-1, 3), default_image.reshape(-1, 3))
    else:
        assert moved > 0 and off.mean() > 0.01, f"{_name(kw)} does not move the image"


def test_matrix_names_every_branch():
    """Each non-default BRDFConfig field is set by at least one case."""
    default = BRDFConfig()
    for f in default.__dataclass_fields__:
        assert any(f in kw and kw[f] != getattr(default, f) for kw in CASES), f
    assert len(CASES) == 14


def test_chip_smoke_renders_this_matrix():
    """chip_smoke.py phase 17b renders these cases under this config on the
    card (it imports no JAX, so it keeps the list in the port's types)."""
    import chip_smoke

    assert [port_config(BRDFConfig(**kw)) for kw in BRDF_MATRIX] == \
        [tconfig.BRDFConfig(**kw) for kw in chip_smoke.brdf_matrix()]
    assert chip_smoke.parity_configs()["matrix"] == port_config(CFG)
