"""The converged-mean fixture of the port's parity gates and a cut live
check of the config it holds.

``tests/golden/bench_converged_160x90_48spp.npz`` holds the JAX package's
converged renders of the bench scene (tests/torch_converged_fixture.py:
experiments/bf16_precision.py's config, f32 and bf16 at seed 0);
chip_smoke.py phase 17a holds the port's renders on the card to them. Here:
the file is what it says it is, its statistics are its own and
docs/BF16_PRECISION_r05.json's, and the port's Renderer gives the JAX
Renderer's image on the same scene and config at 16x9 over 2 ticks (the
tick loop, the keys per tick, AA, the Morton order and the depth-keyed
accumulation of the bench scene), by tests/test_torch_render.py::_agree."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from bench import build_bench_scene as jbuild_bench_scene  # noqa: E402
from physically_based_ray_tracer_tpu.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.render.renderer import Renderer as JRenderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene  # noqa: E402
from tests import torch_converged_fixture as fixture  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import port_config  # noqa: E402

DOCS = os.path.join(fixture.ROOT, "docs", "BF16_PRECISION_r05.json")
LIVE_W, LIVE_H, LIVE_TICKS = 16, 9, 2


@pytest.fixture(scope="module")
def stored():
    with np.load(fixture.FIXTURE) as fx:
        return {k: fx[k] for k in fx.files}


@pytest.fixture(scope="module")
def bench():
    jscene, jcam, depth = jbuild_bench_scene()
    scene, cam, tdepth = build_bench_scene(device="cpu")
    assert tdepth == depth
    return jscene, jcam, scene, cam, depth


def test_fixture_images(stored):
    for k in ("f32", "bf16"):
        img = stored[k]
        assert img.dtype == np.float32 and img.shape == (90, 160, 3)
        assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
        assert img.mean() > 0.01                 # not blank
    assert not np.array_equal(stored["f32"], stored["bf16"])


def test_fixture_metadata(stored, bench):
    depth = bench[-1]
    assert int(stored["seed"]) == fixture.SEED == 0
    assert int(stored["spp"]) == chip_smoke.CONV_SPP == 48
    assert stored["resolution"].tolist() == [chip_smoke.CONV_WIDTH,
                                             chip_smoke.CONV_HEIGHT] == [160, 90]
    fields = json.loads(str(stored["config"]))
    assert fields == chip_smoke.converged_fields(depth)
    assert fields == dict(width=160, height=90, bounces=4, antialias=True, skybox=False,
                          max_stack_depth=max(depth + 2, 32), one_shadow_ray=True)
    assert str(stored["jax_version"]).count(".") >= 2


def test_fixture_statistics(stored):
    """The file's bf16-vs-f32 statistics are its images', and reproduce
    docs/BF16_PRECISION_r05.json's (the same config, taken on the CPU by
    experiments/bf16_precision.py) within 2% relative."""
    own = json.loads(str(stored["bf16_vs_f32"]))
    assert own == chip_smoke.image_stats(stored["bf16"], stored["f32"])
    with open(DOCS) as fh:
        docs = json.load(fh)["bf16_vs_f32"]
    for k in ("mse", "mean_abs"):
        assert abs(own[k] / docs[k] - 1.0) <= 0.02, (k, own[k], docs[k])


def test_chip_smoke_gates_read_the_docs():
    """chip_smoke.py phase 17a takes its gates' limits from
    docs/BF16_PRECISION_r05.json."""
    with open(DOCS) as fh:
        docs = json.load(fh)
    assert chip_smoke.CONV_JAX_BF16_VS_F32_MSE == docs["bf16_vs_f32"]["mse"]
    assert chip_smoke.CONV_FLOOR == docs["noise_floor_f32_vs_f32b"]


@pytest.mark.parametrize("leaf_precision", ["f32", "bf16"])
def test_cut_render_matches_jax(leaf_precision, bench):
    jscene, jcam, scene, cam, depth = bench
    cfg = RenderConfig(**{**chip_smoke.converged_fields(depth), "width": LIVE_W,
                          "height": LIVE_H}, leaf_precision=leaf_precision)
    jr = JRenderer(jscene, jcam, cfg)
    r = Renderer(scene, cam, port_config(cfg), device="cpu")
    engine = trace if leaf_precision == "f32" else trace_bf16
    engine.reset_counts()
    for _ in range(LIVE_TICKS):
        want = jr.tick(jax.random.key(fixture.SEED))
        got = r.tick(fixture.SEED)
        assert want.mean() > 0.01
        _agree(got.reshape(-1, 3), want.reshape(-1, 3))
    assert engine.PLAIN_CALLS["closest"] > 0 and engine.PLAIN_CALLS["any"] > 0
    assert r.sample == LIVE_TICKS
