"""The Cornell golden through the port, and the port's demo presets pinned
to the JAX package's.

The golden is tests/test_golden_configs.py's: ``cornell_scene(area_light=
True)``, 64x64, 4 bounces, no AA, ``skybox=False``, ``max_stack_depth=32``,
the default bf16 engine, one tick with key 0, held to
``tests/golden/cornell_64.png`` with that test's ``_check`` tolerance (MSE
< 1e-5, max-abs < 6/255). The PNG is the JAX package's and is not
regenerated here. The port renders it on the CPU (the bf16 kernel's plain
version), once on the JAX package's tables and once on a scene built by the
port's own builders. The presets' tables are compared byte for byte."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.scene import presets as jpresets  # noqa: E402
from physically_based_ray_tracer_tpu_torch.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import presets  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.procedural import (  # noqa: E402
    make_cornell_walls, make_sphere)
from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance, MeshModel,  # noqa: E402
                                                               build_scene)
from tests.scenes import cornell_scene  # noqa: E402
from tests.test_golden_configs import CORNELL_GOLDEN, _check  # noqa: E402
from tests.torch_port import port_camera, port_scene, scene_arrays  # noqa: E402

GOLDEN_CFG = RenderConfig(width=64, height=64, bounces=4, antialias=False,
                          skybox=False, max_stack_depth=32)


def _port_cornell_scene():
    """tests/scenes.py::cornell_scene(area_light=True), built by the port."""
    walls = make_cornell_walls(1.0)
    models = [MeshModel.from_fat(fat, base_color=color, roughness=0.9)
              for fat, color in walls]
    models.append(MeshModel.from_fat(
        make_sphere(center=(0.3, -0.6, -0.3), radius=0.35, lat=10, lon=14),
        base_color=(0.73, 0.73, 0.73), roughness=0.6))
    lights = LightSet.make(
        area_pos=[[0.0, 0.98, 0.0]], area_color=[[18.0, 15.0, 9.0]],
        area_u=[[0.25, 0.0, 0.0]], area_v=[[0.0, 0.0, 0.25]], device="cpu")
    scene, _ = build_scene(models, [Instance(i) for i in range(len(models))], lights,
                           device="cpu")
    return scene


@pytest.mark.parametrize("tables", ["jax", "port"])
def test_cornell_area_light_golden(tables):
    jscene, jcam = cornell_scene(area_light=True)
    scene = port_scene(jscene) if tables == "jax" else _port_cornell_scene()
    assert GOLDEN_CFG.leaf_precision == "bf16"
    img = Renderer(scene, port_camera(jcam), GOLDEN_CFG, device="cpu").tick(0)
    assert img.mean() > 0.01, "Cornell render suspiciously dark"
    _check(img, CORNELL_GOLDEN)


def _same_scene(scene, jscene):
    """Every table of the port's SceneData equal, byte for byte, to the JAX
    package's (bf16 tables compared as their bits)."""
    for name, x in scene_arrays(jscene, bvh=True).items():
        y = getattr(scene, name)
        if isinstance(x, dict):
            for k, v in x.items():
                got = getattr(y, k)
                if got.dtype == torch.bfloat16:
                    got, v = got.view(torch.int16), v.view(np.int16)
                assert got.numpy().tobytes() == np.asarray(v).tobytes(), (name, k)
        else:
            assert y.numpy().astype(x.dtype).tobytes() == x.tobytes(), name


@pytest.mark.parametrize("name,kw", [("cornell_box", {}),
                                     ("cornell_box", {"area_light": False}),
                                     ("sphere_demo", {})])
def test_preset_tables_match_jax(name, kw):
    scene, cam = getattr(presets, name)(device="cpu", **kw)
    jscene, jcam = getattr(jpresets, name)(**kw)
    _same_scene(scene, jscene)
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(getattr(cam, f.name).numpy(),
                                      np.asarray(getattr(jcam, f.name)))


def test_bf16_near_ties_follow_the_reference_walk():
    """The golden's primary rays through the bf16 kernel's plain version and
    the JAX package's kernel (interpret mode), on the same co-sorted lanes:
    the same winner key on every lane, the near-tie lanes included (exact
    bf16 t-ties across leaf groups on the room's edges, which the
    reference's tile walk breaks by its visit order)."""
    import jax.numpy as jnp

    from physically_based_ray_tracer_tpu.ops import pallas_bf16
    from physically_based_ray_tracer_tpu.scene.camera import primary_rays as jprimary_rays
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16

    jscene, jcam = cornell_scene(area_light=True)
    ids = jnp.arange(64 * 64, dtype=jnp.int32)
    o, d = jprimary_rays(jcam, (ids % 64).astype(jnp.float32),
                         (ids // 64).astype(jnp.float32), 64, 64)
    dense = port_scene(jscene).dense
    o, d = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    _, o_s, d_s, tm_s = trace._cosort_rays(dense, o, d, torch.full((4096,), 1e30))
    t, gk, inst, near = trace_bf16.plain_traverse_bf16(dense, o_s, d_s, tm_s, True)
    jt, jgk, _ = pallas_bf16._call_bf16(jscene.dense, jnp.asarray(o_s.numpy()),
                                        jnp.asarray(d_s.numpy()), jnp.asarray(tm_s.numpy()),
                                        closest=True, interpret=True)
    assert int(near.sum()) > 0
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jgk))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
