"""Ready-made scenes.

``build_bench_scene`` is the scene of the repository's throughput benchmark
(``bench.py::build_bench_scene``), built by the port: 9 instanced 32x64 UV
spheres plus a floor (36,866 world triangles), 4 point lights, 1
directional and 1 spot light. ``flatten="auto"`` keeps it two-level (the
flattened tables fail the fast-memory check), as the JAX package does. Like
``bench.py``, it builds no classic BVH unless asked (``legacy_bvh=True``:
the wave engine's tree, 16 triangles per leaf).
"""

from __future__ import annotations

from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
from physically_based_ray_tracer_tpu_torch.scene.procedural import (make_quad,
                                                                    make_sphere)
from physically_based_ray_tracer_tpu_torch.scene.scene import (
    Instance, MeshModel, build_scene_instanced)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def build_bench_scene(dense_leaf_target: int = 16, flatten="auto",
                      legacy_bvh: bool = False, device=DEFAULT_DEVICE):
    """Returns (scene_data, camera, depth) on ``device``."""
    device = resolve(device)
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=32, lon=64),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                metalness=0.2)
    floor = MeshModel.from_fat(
        make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8], [-8, -1, 8]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2], [-2, 3, -1], [0, 5, 0], [3, 2, -3]],
        point_color=[[20, 20, 20], [10, 12, 14], [6, 6, 6], [8, 4, 2]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
        device=device)
    instances = [Instance(0, position=(dx, 0, dz))
                 for dx in (-2.2, 0.0, 2.2) for dz in (-2.2, 0.0, 2.2)]
    instances.append(Instance(1))
    scene, _meta, depth = build_scene_instanced(
        [sphere, floor], instances, lights, legacy_bvh=legacy_bvh,
        dense_leaf_target=dense_leaf_target, flatten=flatten, device=device)
    cam = Camera.make(pos=(0, 2.5, 7), target=(0, 0, 0), device=device)
    return scene, cam, depth
