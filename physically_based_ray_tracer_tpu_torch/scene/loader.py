"""High-level scene loading: reference scene directories -> SceneData;
counterpart of ``physically_based_ray_tracer_tpu/scene/loader.py``.

Loads the models, scans the scene directory's GameObject and light JSONs,
builds the acceleration structures, and reads the camera from
``prefabs/camera.json`` and the skydome from ``skydomes/workshop3.hdr``
when they are present.
"""

from __future__ import annotations

import os

from physically_based_ray_tracer_tpu_torch.models.gltf import load_gltf
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.scene import (build_scene,
                                                               build_scene_instanced)
from physically_based_ray_tracer_tpu_torch.scene.serialization import (load_camera_json,
                                                                       load_scene_dir)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.image import read_hdr


def load_reference_scene(assets_root: str, scene_name: str = "scene1",
                         model_paths: list[str] | None = None,
                         include_point_lights: bool = True,
                         load_sky: bool = True,
                         instanced: bool = True,
                         return_handle: bool = False,
                         device=DEFAULT_DEVICE):
    """Load a reference-format asset tree onto ``device``.

    ``model_paths``: glTF/GLB files in modelIndex order; defaults to the
    reference scene1 model list (SciFiHelmet only). ``instanced=True``
    builds the two-level structure (a shared BLAS per model + a TLAS over
    instances, with the classic BVH), whose instances ``rebuild_scene``
    moves; False bakes one single-level tree. ``return_handle=True`` also
    returns the ``InstancedScene`` handle that ``rebuild_scene`` needs (None
    with ``instanced=False``).

    Returns (scene_data, camera, bvh_depth[, handle]).
    """
    device = resolve(device)
    if model_paths is None:
        model_paths = [os.path.join(
            assets_root, "prefabs/models/SciFiHelmet/SciFiHelmet.gltf")]

    models = [load_gltf(p) for p in model_paths]
    scene_dir = os.path.join(assets_root, scene_name)
    instances, lights = load_scene_dir(scene_dir, device=device,
                                       include_point_lights=include_point_lights)
    lights = lights.pad_points(4)

    sky = None
    if load_sky:
        sky_path = os.path.join(assets_root, "skydomes/workshop3.hdr")
        if os.path.exists(sky_path):
            sky = read_hdr(sky_path)

    handle = None
    if instanced:
        scene, handle, depth = build_scene_instanced(models, instances, lights, sky=sky,
                                                     device=device)
    else:
        scene, depth = build_scene(models, instances, lights, sky=sky, device=device)

    cam_path = os.path.join(assets_root, "prefabs/camera.json")
    cam = (load_camera_json(cam_path, device=device) if os.path.exists(cam_path)
           else Camera.make((0, 0, 3), (0, 0, 0), device=device))
    if return_handle:
        return scene, cam, depth, handle
    return scene, cam, depth
