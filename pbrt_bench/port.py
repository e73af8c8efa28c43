"""The program under test: the PyTorch and CUDA port, built from the
benchmark's scene inputs through its public entry points."""

from __future__ import annotations

import importlib

PORT = "physically_based_ray_tracer_tpu_torch"


def load():
    """The port's modules the drivers use (imported here, so that a checkout
    without the port fails with a plain message)."""
    try:
        mods = {name: importlib.import_module(f"{PORT}.{name}")
                for name in ("config", "scene.scene", "scene.lights", "scene.camera",
                             "render.renderer", "diff.grad", "diff.inverse")}
    except ImportError as exc:
        raise SystemExit(f"the program under test ({PORT}) cannot be imported: {exc}")
    return mods


def render_config(mods, cfg: dict, engine: dict):
    """The port's RenderConfig of a configuration's render settings and a
    traffic mix's engine settings."""
    return mods["config"].RenderConfig(**cfg["render"], **engine)


def build_scene(mods, inputs: dict, build: dict, device):
    """(SceneData, Camera, instance list) on ``device``, built by
    ``build_scene_instanced`` without the classic BVH (no dense engine reads
    it)."""
    sc = mods["scene.scene"]
    models = [sc.MeshModel(corners=m["corners"], normals=m["normals"], uvs=m["uvs"],
                           face_normals=m["face_normals"], base_color=tuple(m["base_color"]),
                           metalness=m["metalness"], roughness=m["roughness"],
                           emissive=tuple(m["emissive"]), transmissivness=m["transmissivness"],
                           reflectance=m["reflectance"], opacity=m["opacity"])
              for m in inputs["models"]]
    instances = [sc.Instance(i["model"], position=tuple(i["position"]),
                             rotation=tuple(i["rotation"]), scale=tuple(i["scale"]))
                 for i in inputs["instances"]]
    lights = {k: (v if len(v) else None) for k, v in inputs["lights"].items()}
    light_set = mods["scene.lights"].LightSet.make(**lights, device=device)
    scene, _, _ = sc.build_scene_instanced(models, instances, light_set, legacy_bvh=False,
                                           device=device, **build)
    cam = mods["scene.camera"].Camera.make(pos=inputs["camera"]["pos"],
                                           target=inputs["camera"]["target"], device=device)
    return scene, cam, instances
