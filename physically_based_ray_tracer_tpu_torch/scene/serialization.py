"""Reference-format JSON scene serialization; counterpart of
``physically_based_ray_tracer_tpu/scene/serialization.py``.

The reference's JSON files are its persistent state: the camera
(``prefabs/camera.json``), GameObjects (``<scene>/*.json``) and lights
(``<scene>/{pointlights,directionallights,spotlights}/*.json``). This
module reads and writes those formats, so reference scenes load unmodified.
Readers that build tensors take ``device`` (the card unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import json
import math
import os

from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.lights import (LightSet,
                                                                lights_from_reference_json)
from physically_based_ray_tracer_tpu_torch.scene.scene import Instance
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE


def load_camera_json(path: str, device=DEFAULT_DEVICE) -> Camera:
    """Read camera.json {pX,pY,pZ,tX,tY,tZ}."""
    with open(path) as f:
        d = json.load(f)
    return Camera.make(pos=(d["pX"], d["pY"], d["pZ"]),
                       target=(d["tX"], d["tY"], d["tZ"]), device=device)


def save_camera_json(path: str, cam: Camera):
    """Write camera.json in the reference's format."""
    p = cam.pos.cpu().numpy()
    t = cam.target.cpu().numpy()
    data = {"pX": float(p[0]), "pY": float(p[1]), "pZ": float(p[2]),
            "tX": float(t[0]), "tY": float(t[1]), "tZ": float(t[2])}
    with open(path, "w") as f:
        json.dump(data, f, indent=4)


def load_gameobject_json(path: str) -> Instance:
    """Read a GameObject JSON (modelIndex + positionX.. / rotationX.. /
    scaleX.. fields). Rotations are stored in degrees in the scene files
    and converted to radians here."""
    with open(path) as f:
        d = json.load(f)
    deg = math.pi / 180.0
    return Instance(
        model=int(d.get("modelIndex", 0)),
        position=(d.get("positionX", 0.0), d.get("positionY", 0.0), d.get("positionZ", 0.0)),
        rotation=(d.get("rotationX", 0.0) * deg, d.get("rotationY", 0.0) * deg,
                  d.get("rotationZ", 0.0) * deg),
        scale=(d.get("scaleX", 1.0), d.get("scaleY", 1.0), d.get("scaleZ", 1.0)),
        name=os.path.splitext(os.path.basename(path))[0])


def save_gameobject_json(path: str, inst: Instance, physics_type: str = "static"):
    """Write a GameObject JSON in the reference's format (rotations in
    degrees)."""
    rad = 180.0 / math.pi
    data = {
        "modelIndex": inst.model,
        "physicsType": physics_type,
        "positionX": float(inst.position[0]), "positionY": float(inst.position[1]),
        "positionZ": float(inst.position[2]),
        "rotationX": float(inst.rotation[0] * rad), "rotationY": float(inst.rotation[1] * rad),
        "rotationZ": float(inst.rotation[2] * rad),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=4)


def save_light_json(path: str, position, color, rotation=(0.0, 0.0, 0.0)):
    """Write a light JSON in the reference's format."""
    data = {"pX": float(position[0]), "pY": float(position[1]), "pZ": float(position[2]),
            "cX": float(color[0]), "cY": float(color[1]), "cZ": float(color[2]),
            "rX": float(rotation[0]), "rY": float(rotation[1]), "rZ": float(rotation[2])}
    with open(path, "w") as f:
        json.dump(data, f, indent=4)


def load_scene_dir(scene_dir: str, include_point_lights: bool = True,
                   device=DEFAULT_DEVICE) -> tuple[list[Instance], LightSet]:
    """Scan a reference scene directory: every top-level ``*.json`` is a
    GameObject (sorted by name); light subdirectories populate the LightSet.

    ``include_point_lights=False`` replicates the reference quirk that point
    lights are never loaded from JSON; as in the JAX package, that LightSet
    keeps the directional and spot lights only."""
    instances = []
    for f in sorted(os.listdir(scene_dir)):
        p = os.path.join(scene_dir, f)
        if f.endswith(".json") and os.path.isfile(p):
            instances.append(load_gameobject_json(p))
    lights = lights_from_reference_json(scene_dir, device=device)
    if not include_point_lights:
        np_ = lambda x: x.cpu().numpy()
        lights = LightSet.make(
            dir_pos=np_(lights.dir_pos), dir_color=np_(lights.dir_color),
            spot_pos=np_(lights.spot_pos), spot_color=np_(lights.spot_color),
            spot_rot=np_(lights.spot_rot), device=device)
    return instances, lights
