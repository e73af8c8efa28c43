"""Ready-made scenes; counterpart of ``physically_based_ray_tracer_tpu/scene/presets.py``.

``sphere_demo`` (a UV sphere on a floor, one point, one directional and one
spot light) and ``cornell_box`` (a Cornell-style room with two spheres and
an area light, or a point light) are the JAX package's demo scenes, built
by the port's copies of its builders into the same tables.

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
from physically_based_ray_tracer_tpu_torch.scene.procedural import (
    make_cornell_walls, make_quad, make_sphere)
from physically_based_ray_tracer_tpu_torch.scene.scene import (
    Instance, MeshModel, build_scene, build_scene_instanced)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def build_bench_scene(dense_leaf_target: int = 16, flatten="auto",
                      legacy_bvh: bool = False, return_handle: bool = False,
                      device=DEFAULT_DEVICE):
    """Returns (scene_data, camera, depth) on ``device``; with
    ``return_handle``, (scene_data, camera, depth, handle), the
    ``InstancedScene`` that ``rebuild_scene`` moves the spheres with (its
    ``models`` and ``instances`` are the scene's)."""
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
    scene, handle, depth = build_scene_instanced(
        [sphere, floor], instances, lights, legacy_bvh=legacy_bvh,
        dense_leaf_target=dense_leaf_target, flatten=flatten, device=device)
    cam = Camera.make(pos=(0, 2.5, 7), target=(0, 0, 0), device=device)
    if return_handle:
        return scene, cam, depth, handle
    return scene, cam, depth


def sphere_demo(device=DEFAULT_DEVICE):
    """Triangle-mesh sphere on a floor + point, directional and spot light.
    Returns (scene_data, camera) on ``device``."""
    device = resolve(device)
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=32, lon=64),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                metalness=0.1)
    floor = MeshModel.from_fat(
        make_quad([-8, -1, -8], [8, -1, -8], [8, -1, 8], [-8, -1, 8]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.0, 0.95, 0.85]],
        spot_pos=[[-2, 4, 1]], spot_color=[[10, 10, 12]], spot_rot=[[0, -1, 0]],
        device=device).pad_points(4)
    scene, _ = build_scene([sphere, floor], [Instance(0), Instance(1)], lights,
                           device=device)
    cam = Camera.make(pos=(0, 1.2, 4), target=(0, 0, 0), device=device)
    return scene, cam


def cornell_box(area_light: bool = True, device=DEFAULT_DEVICE):
    """Cornell-style box with two spheres, lit by an area light (or a point
    light). Returns (scene_data, camera) on ``device``."""
    device = resolve(device)
    walls = make_cornell_walls(1.0)
    models = [MeshModel.from_fat(fat, base_color=color, roughness=0.9)
              for fat, color in walls]
    ball = MeshModel.from_fat(
        make_sphere(center=(0.35, -0.62, -0.25), radius=0.38, lat=24, lon=48),
        base_color=(0.73, 0.73, 0.73), roughness=0.4, metalness=0.2)
    ball2 = MeshModel.from_fat(
        make_sphere(center=(-0.4, -0.7, 0.3), radius=0.3, lat=24, lon=48),
        base_color=(0.9, 0.9, 0.9), metalness=1.0, roughness=0.05)
    models += [ball, ball2]
    instances = [Instance(i) for i in range(len(models))]
    if area_light:
        lights = LightSet.make(
            area_pos=[[0.0, 0.98, 0.0]], area_color=[[18.0, 15.0, 9.0]],
            area_u=[[0.25, 0.0, 0.0]], area_v=[[0.0, 0.0, 0.25]], device=device)
    else:
        lights = LightSet.make(point_pos=[[0, 0.9, 0]], point_color=[[3, 3, 3]],
                               device=device).pad_points(4)
    scene, _ = build_scene(models, instances, lights, device=device)
    cam = Camera.make(pos=(0, 0, 3.2), target=(0, 0, 0), device=device)
    return scene, cam
