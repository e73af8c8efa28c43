"""Port-wide contracts: nothing of JAX or of the JAX package anywhere in the
port, a configuration that mirrors the JAX package's, every option it does
not carry raises NotImplementedError (before any device work), every entry
point runs on the CUDA card unless asked for the CPU, and the GPU smoke run
refuses to run (without printing a result) where there is no GPU or no
port."""

import dataclasses
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu import config as jconfig  # noqa: E402
from physically_based_ray_tracer_tpu.scene import scene as jscene_mod  # noqa: E402
from physically_based_ray_tracer_tpu_torch import animate, inverse_material  # noqa: E402
from physically_based_ray_tracer_tpu_torch import config as tconfig  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import cache  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.dense import DenseBVH  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh.types import BVHArrays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu_torch.diff import grad as dgrad  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import (  # noqa: E402
    check_supported, render_sample)
from physically_based_ray_tracer_tpu_torch.render import debugger  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.film import FilmState  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import lights as lights_mod  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import loader, presets  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import scene as tscene  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera, primary_rays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene  # noqa: E402
from physically_based_ray_tracer_tpu_torch.session import EditSession  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_parts, instanced_scene,  # noqa: E402
                              port_camera, port_config, port_handle, port_instances,
                              port_models, port_scene, scene_arrays)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "physically_based_ray_tracer_tpu_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "physically_based_ray_tracer_tpu_torch.ops.trace" in mods
    assert "physically_based_ray_tracer_tpu_torch.ops.trace_bf16" in mods
    assert "physically_based_ray_tracer_tpu_torch.ops.trace_rows" in mods
    for m in ("cli", "ops.tonemap", "utils.image", "utils.timer", "models.obj",
              "models.gltf", "models.textures", "models.resources",
              "scene.serialization", "scene.loader", "scene.presets", "session",
              "animate", "bvh.refit", "bvh.cache", "render.debugger",
              "utils.debug_draw", "diff.grad", "diff.inverse", "diff.checkpoint",
              "inverse_material"):
        assert f"physically_based_ray_tracer_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            + "       ('jax', 'jaxlib', 'physically_based_ray_tracer_tpu')]\n"
            + "assert not bad, bad\n"
            + "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        text = p.read_text()
        assert "import jax" not in text and "from jax" not in text, p
        assert "physically_based_ray_tracer_tpu." not in text, p


def test_config_mirrors_jax():
    """The port's config.py is the JAX package's, field for field: the
    same constants, enum members, dataclass fields and defaults."""
    consts = lambda m: {k: v for k, v in vars(m).items()
                        if k.isupper() and not isinstance(v, type)}
    assert consts(tconfig) == consts(jconfig)
    for name in ("RenderMode", "NDF", "DiffuseModel", "SpecularModel"):
        members = lambda m: [(e.name, e.value) for e in getattr(m, name)]
        assert members(tconfig) == members(jconfig), name
    for name in ("BRDFConfig", "RenderConfig"):
        tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
        assert ([f.name for f in dataclasses.fields(tcls)]
                == [f.name for f in dataclasses.fields(jcls)]), name
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls()), name
    assert port_config(SLICE_CFG).n_pixels == SLICE_CFG.n_pixels
    assert dataclasses.asdict(port_config(SLICE_CFG)) == dataclasses.asdict(SLICE_CFG)


@pytest.mark.parametrize("kw,name", [
    (dict(leaf_precision="fp16"), "leaf_precision"),
    (dict(traversal="bvh8"), "traversal"),
    (dict(traversal="Lane"), "traversal"),
    (dict(reshard_axis="x", reshard_ndev=2), "reshard_axis"),
])
def test_unported_options_raise(kw, name):
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(SLICE_CFG).replace(**kw)
    with pytest.raises(NotImplementedError, match=name):
        check_supported(cfg, scene)
    with pytest.raises(NotImplementedError, match=name):
        render_sample(scene, cam, cfg, 0, 0, torch.arange(4, dtype=torch.int32))
    # refused before any device work: also with the default device (the
    # card), where there is none
    for device in ({}, {"device": "cpu"}):
        with pytest.raises(NotImplementedError, match=name):
            Renderer(scene, cam, cfg, **device)


def test_default_config_and_sky_raise():
    """RenderConfig's default engine (bf16) is taken; a scene with a sky
    image renders with skybox=True, and the Panini projection runs: neither
    raises any more."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    r = Renderer(scene, cam, RenderConfig(width=8, height=8), device="cpu")
    assert r.config.leaf_precision == "bf16"
    sky_scene = dataclasses.replace(scene, sky=torch.ones((4, 8, 3)))
    cfg = port_config(SLICE_CFG).replace(width=4, height=4)
    check_supported(cfg.replace(skybox=True), sky_scene)
    img = Renderer(sky_scene, cam, cfg.replace(skybox=True), device="cpu").tick()
    dark = Renderer(sky_scene, cam, cfg.replace(skybox=False), device="cpu").tick()
    assert np.isfinite(img).all() and (img >= dark).all() and (img > dark).any()
    _, d = primary_rays(cam, torch.zeros(2), torch.zeros(2), 8, 8, panini=True)
    assert np.isfinite(d.numpy()).all()


@pytest.mark.parametrize("leaf_precision", ["bf16", "f32"])
def test_rows_engine_supported(leaf_precision):
    """traversal="pallas_rows" is carried, whatever leaf_precision says (it
    does not apply to that engine, as in the JAX package)."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(SLICE_CFG).replace(traversal="pallas_rows",
                                         leaf_precision=leaf_precision)
    check_supported(cfg, scene)
    r = Renderer(scene, cam, cfg, device="cpu")
    assert r.device == torch.device("cpu")


def _entry_points():
    """Every entry point that allocates, called without ``device=``."""
    models, instances, lights, jcam = instanced_parts()
    jscene, _ = instanced_scene()
    jscene2, jhandle, _ = jscene_mod.build_scene_instanced(models, instances, lights,
                                                           legacy_bvh=False)
    arrays = scene_arrays(jscene)
    d = arrays["dense"]
    scene = port_scene(jscene)
    cam = port_camera(jcam)
    return {
        "Renderer": (Renderer.__init__, lambda: Renderer(scene, cam, port_config(SLICE_CFG))),
        "build_bench_scene": (build_bench_scene, build_bench_scene),
        "scene_from_numpy": (tscene.scene_from_numpy,
                             lambda: tscene.scene_from_numpy(arrays)),
        "build_scene": (tscene.build_scene, lambda: tscene.build_scene(
            port_models(models), port_instances(instances))),
        "build_scene_instanced": (tscene.build_scene_instanced,
                                  lambda: tscene.build_scene_instanced(
                                      port_models(models), port_instances(instances))),
        "Camera.make": (Camera.make, lambda: Camera.make((0, 2, 6), (0, 0, 0))),
        "LightSet.make": (LightSet.make, lambda: LightSet.make(point_pos=[[0, 1, 0]])),
        "DenseBVH.from_numpy": (DenseBVH.from_numpy, lambda: DenseBVH.from_numpy(
            d["nodes16"], d["groups"], d["inst16"], d["prim_base"], d["world_lo"],
            d["world_hi"])),
        "FilmState.zeros": (FilmState.zeros, lambda: FilmState.zeros(16)),
        "sphere_demo": (presets.sphere_demo, presets.sphere_demo),
        "cornell_box": (presets.cornell_box, presets.cornell_box),
        "load_reference_scene": (loader.load_reference_scene,
                                 lambda: loader.load_reference_scene(str(ROOT / "absent"))),
        "lights_from_reference_json": (
            lights_mod.lights_from_reference_json,
            lambda: lights_mod.lights_from_reference_json(str(ROOT / "absent"))),
        "BVHArrays.from_numpy": (BVHArrays.from_numpy, lambda: BVHArrays.from_numpy(
            np.zeros((1, 12)), np.zeros((1, 2)), np.zeros((16, 9)), np.zeros(16))),
        "rebuild_scene": (tscene.rebuild_scene, lambda: tscene.rebuild_scene(
            scene, port_handle(jhandle, jscene2.dense), port_instances(instances))),
        "EditSession": (EditSession.__init__, lambda: EditSession(str(ROOT / "absent"))),
        "trace_pixel": (debugger.trace_pixel, lambda: debugger.trace_pixel(
            scene, cam, port_config(SLICE_CFG), 1, 1)),
        "pixel_grid": (debugger.pixel_grid, lambda: debugger.pixel_grid(
            scene, cam, port_config(SLICE_CFG), 1, 1)),
        "load_bvh": (cache.load_bvh, lambda: cache.load_bvh(str(ROOT / "absent"))),
        "load_dense": (cache.load_dense, lambda: cache.load_dense(str(ROOT / "absent"))),
        "cached_build_bvh": (cache.cached_build_bvh, lambda: cache.cached_build_bvh(
            str(ROOT / "absent"), np.zeros((1, 3, 3)), None)),
        "animate.run": (animate.run, lambda: animate.run(frames=1, size=4)),
        "inverse_material.run": (inverse_material.run,
                                 lambda: inverse_material.run(steps=1, size=4)),
        "params_from_numpy": (dgrad.params_from_numpy,
                              lambda: dgrad.params_from_numpy({"roughness": [0.5]})),
        "trs_params_from_instances": (dgrad.trs_params_from_instances,
                                      lambda: dgrad.trs_params_from_instances(
                                          port_instances(instances))),
    }


ENTRY_POINTS = ["Renderer", "build_bench_scene", "scene_from_numpy", "build_scene",
                "build_scene_instanced", "Camera.make", "LightSet.make",
                "DenseBVH.from_numpy", "FilmState.zeros", "BVHArrays.from_numpy",
                "sphere_demo", "cornell_box", "load_reference_scene",
                "lights_from_reference_json", "rebuild_scene", "EditSession",
                "trace_pixel", "pixel_grid", "load_bvh", "load_dense", "cached_build_bvh",
                "animate.run", "inverse_material.run", "params_from_numpy",
                "trs_params_from_instances"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    """Each entry point's device defaults to the CUDA card; without one, a
    call that does not ask for the CPU raises instead of running there."""
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default call would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without CUDA, and in a directory holding only chip_smoke.py, the
    smoke run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    for cwd in (ROOT, tmp_path):
        script = cwd / "chip_smoke.py"
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

