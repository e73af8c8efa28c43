"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
carry a scene, its instanced handle or a configuration of the JAX package
over to the port, a small two-level instanced scene built identically by
both packages, and the JAX package's native BVH builders loaded before a
test compares the port's builders with them."""

import dataclasses
import enum
import fcntl
import os
import shutil
import time

import numpy as np
import pytest
import torch

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera
from physically_based_ray_tracer_tpu.scene.lights import LightSet as JLightSet
from physically_based_ray_tracer_tpu.scene.procedural import (make_quad,
                                                              make_sphere)
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance
from physically_based_ray_tracer_tpu.scene.scene import MeshModel as JMeshModel
from physically_based_ray_tracer_tpu.scene.scene import build_scene_instanced
from physically_based_ray_tracer_tpu_torch import config as tconfig
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance,
                                                               InstancedScene,
                                                               MeshModel,
                                                               scene_from_numpy)

# One intra-op thread per test process: the test suite runs several
# processes side by side on the host's cores, and PyTorch's default (a
# thread per core in each process) oversubscribes them; the port's tests
# run many small-tensor operations that gain nothing from more threads.
torch.set_num_threads(1)

# serialises the port's test processes around the JAX package's native loader
NATIVE_LOCK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "build", "jax_native.lock")

# the repository's 32x16 HDR sky fixture (tests/test_golden_configs.py)
SKY_FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "sky_32x16.hdr")

# The whole slice at test size: 2 bounces, AA, one shadow ray, f32 engine.
SLICE_CFG = RenderConfig(width=16, height=16, bounces=2, antialias=True,
                         skybox=False, accumulate=False, traversal="pallas",
                         leaf_precision="f32", one_shadow_ray=True)


def ensure_jax_native(tries: int = 20, pause: float = 0.5) -> None:
    """Make sure the JAX package's native builders load
    (``bvh.native.get_lib()`` and ``get_sbvh_lib()`` return a library).

    That loader compiles with ``g++ ... -o`` straight onto the library's
    path, not atomically: a process that loads the file while another
    writes it fails (``file too short``, ``invalid ELF header``), and the
    loader keeps the failure for the whole process (``_tried`` /
    ``_sbvh_tried``), after which the JAX package builds other tables or
    none. Where ``g++`` exists, a cached failure is cleared and the load
    tried again, up to ``tries`` times ``pause`` seconds apart, under a
    file lock (``NATIVE_LOCK``) that keeps the port's test processes from
    racing each other. A library that never loads fails the test."""
    from physically_based_ray_tracer_tpu.bvh import native

    os.makedirs(os.path.dirname(NATIVE_LOCK), exist_ok=True)
    with open(NATIVE_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for get, flag, path in ((native.get_lib, "_tried", "_SO_PATH"),
                                    (native.get_sbvh_lib, "_sbvh_tried", "_SBVH_SO_PATH")):
                for attempt in range(tries):
                    if get() is not None:
                        break
                    if attempt == tries - 1 or shutil.which("g++") is None:
                        pytest.fail(
                            f"the JAX package's native builder {getattr(native, path)} "
                            f"did not load in {attempt + 1} tries: its loader "
                            "(physically_based_ray_tracer_tpu/bvh/native.py) writes it "
                            "with a non-atomic `g++ -o`, and a load during the write "
                            "fails and is cached")
                    time.sleep(pause)
                    setattr(native, flag, False)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def port_config(jcfg):
    """The port's RenderConfig / BRDFConfig with the field values of the
    JAX package's ``jcfg`` (enums mapped by value)."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        x = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(x):
            x = port_config(x)
        elif isinstance(x, enum.Enum):
            x = getattr(tconfig, type(x).__name__)(x.value)
        kw[f.name] = x
    return getattr(tconfig, type(jcfg).__name__)(**kw)


def scene_arrays(jscene, bvh: bool = False) -> dict:
    """np.asarray of every field of a JAX SceneData (scene_from_numpy input);
    the classic BVH only with ``bvh=True`` (a scene built with
    ``legacy_bvh=False`` holds a 1-triangle placeholder there)."""
    out = {}
    for name in jscene._fields:
        x = getattr(jscene, name)
        if name == "bvh" and not bvh:
            continue
        if name in ("dense", "lights", "bvh"):
            out[name] = {k: np.asarray(getattr(x, k)) for k in x._fields
                         if getattr(x, k) is not None}
        else:
            out[name] = np.asarray(x)
    return out


def port_scene(jscene, bvh: bool = False):
    return scene_from_numpy(scene_arrays(jscene, bvh), device="cpu")


def port_camera(jcam):
    return Camera.make(np.asarray(jcam.pos), np.asarray(jcam.target),
                       float(jcam.fov), float(jcam.distortion), device="cpu")


def port_models(jmodels):
    return [MeshModel(**{f.name: getattr(m, f.name)
                         for f in dataclasses.fields(m)}) for m in jmodels]


def port_instances(jinstances):
    return [Instance(**{f.name: getattr(i, f.name)
                        for f in dataclasses.fields(i)}) for i in jinstances]


def port_handle(jhandle, jdense):
    """The port's InstancedScene from the JAX package's: the same models,
    instances, TLASMeta and prim offsets. The TLASMeta also carries each
    BLAS's stack need (port-only), counted on the JAX scene's ``jdense``
    table as the port's own build counts it."""
    meta = jhandle.tlas_meta
    if meta is not None:
        nodes = np.asarray(jdense.nodes16).reshape(-1, tdense.NODE_F)
        need = np.array([tdense._walk_need(nodes, int(r)) for r in meta.blas_root],
                        np.int64)
        meta = tdense.TLASMeta(*(np.array(x) if isinstance(x, np.ndarray) else x
                                 for x in meta), blas_need=need)
    return InstancedScene(
        models=port_models(jhandle.models), instances=port_instances(jhandle.instances),
        tlas_meta=meta, leaf_size=jhandle.leaf_size, legacy_bvh=jhandle.legacy_bvh,
        prim_start=np.array(jhandle.prim_start), prim_count=np.array(jhandle.prim_count),
        dense_leaf_target=jhandle.dense_leaf_target, dense_shape=jhandle.dense_shape)


def instanced_parts():
    """(models, instances, lights, camera) of a small two-level scene, in
    the JAX package's types: 3 transformed sphere instances + a floor."""
    sphere = JMeshModel.from_fat(make_sphere(radius=1.0, lat=8, lon=12),
                                 base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                 metalness=0.2)
    floor = JMeshModel.from_fat(
        make_quad([-6, -1, -6], [6, -1, -6], [6, -1, 6], [-6, -1, 6]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    instances = [JInstance(0, position=(-2.0, 0.0, 0.0)),
                 JInstance(0, position=(0.5, 0.2, -1.0), rotation=(0.3, 0.7, 0.1),
                           scale=(0.8, 1.2, 0.9)),
                 JInstance(0, position=(2.2, -0.2, 0.8), scale=(0.6, 0.6, 0.6)),
                 JInstance(1)]
    lights = JLightSet.make(
        point_pos=[[2, 3, 2], [-2, 3, -1]], point_color=[[20, 20, 20], [10, 12, 14]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
    ).pad_points(4)
    cam = JCamera.make(pos=(0, 2.0, 6), target=(0, 0, 0))
    return [sphere, floor], instances, lights, cam


def instanced_scene(sky=None):
    """The JAX package's two-level build of instanced_parts() (with the sky
    image ``sky``, if given)."""
    models, instances, lights, cam = instanced_parts()
    scene, _, _ = build_scene_instanced(models, instances, lights, sky=sky,
                                        legacy_bvh=False, flatten=False)
    return scene, cam


def lone_sphere_scene(sky=None):
    """One instanced sphere seen from outside, in the JAX package's types:
    every bounce ray leaves a convex surface, so from bounce 1 on every
    live lane misses (the integrator's all-miss shortcut)."""
    models, _, lights, _ = instanced_parts()
    scene, _, _ = build_scene_instanced(
        models[:1], [JInstance(0, rotation=(0.2, 0.4, 0.0))], lights, sky=sky,
        legacy_bvh=False, flatten=False)
    return scene, JCamera.make(pos=(0.5, 1.0, 3.5), target=(0, 0, 0))
