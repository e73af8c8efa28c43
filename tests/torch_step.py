"""Helpers of the tests of the port's recorded paths (tests/test_torch_graph.py,
tests/test_torch_inverse.py): the dispatch mode that records host reads and
uploads, and the inverse cell's gradient problem at a small size. This
module imports no JAX, so the card's tests (``--noconftest``) can use it."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import (apply_params, clone_params,
                                                             render_color,
                                                             trs_params_from_instances)
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene


class HostReads(TorchDispatchMode):
    """Records the operations that read the device on the host or upload
    host data: none can be recorded into a CUDA graph. ``_linalg_check_errors``
    reads a factorisation's status on the host inside one operation."""

    FLAGGED = {"_local_scalar_dense", "lift_fresh", "nonzero", "masked_select",
               "is_nonzero", "equal", "_linalg_check_errors"}

    def __init__(self):
        super().__init__()
        self.seen = []
        self.ops = 0
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = func.__name__.split(".")[0]
        self.names.add(name)
        if name in self.FLAGGED:
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def unwatch_plain_engines(monkeypatch) -> None:
    """The dense engines' plain versions (the CPU's; the card runs the
    kernels) run outside any dispatch mode."""
    for module, name in ((trace, "plain_traverse"), (trace_bf16, "plain_traverse_bf16")):
        real = getattr(module, name)

        def plain(*args, _real=real, **kwargs):
            with torch.utils._python_dispatch._disable_current_modes():
                return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, plain)


def bench_step_problem(device, width: int, height: int):
    """The bench scene's inverse problem (``chip_smoke.py``'s and the
    benchmark's inverse cell's) at ``width`` x ``height``: (scene, camera,
    cfg, target, start). ``cfg`` is the cell's engine (exact f32, 4
    bounces, AA, one shadow ray); ``target`` (n_pixels, 3) is the frame at
    the scene's own parameters, key 0, sample 0; ``start`` perturbs every
    group the cell fits: albedo, roughness, metalness, emission, point and
    directional light colours, the TRS of the 10 instances and the
    camera's position and target."""
    cfg = RenderConfig(width=width, height=height, bounces=4, antialias=True, skybox=False,
                       one_shadow_ray=True, leaf_precision="f32")
    scene, cam, _, handle = build_bench_scene(flatten=False, return_handle=True,
                                              device=device)
    trs = trs_params_from_instances(handle.instances, device=device)
    true = {"base_color": scene.mat_base, "roughness": scene.mat_rough,
            "metalness": scene.mat_metal, "emissive": scene.mat_emissive,
            "point_color": scene.lights.point_color, "dir_color": scene.lights.dir_color,
            "instance_trs": trs, "camera_pos": cam.pos, "camera_target": cam.target}
    with torch.no_grad():
        s, c = apply_params(scene, cam, true)
        ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=device)
        target = torch.cat([render_color(s, c, cfg, 0, 0, ids[i:i + 65536])
                            for i in range(0, cfg.n_pixels, 65536)])
    shift = lambda v, dx: v + torch.tensor(dx, dtype=torch.float32, device=device)
    start = clone_params({
        "base_color": torch.clamp(scene.mat_base * 0.8 + 0.1, 0.0, 1.0),
        "roughness": torch.clamp(scene.mat_rough + 0.1, 0.05, 1.0),
        "metalness": torch.clamp(scene.mat_metal + 0.05, 0.0, 1.0),
        "emissive": scene.mat_emissive + 0.02,
        "point_color": scene.lights.point_color * 0.8,
        "dir_color": scene.lights.dir_color * 1.2,
        "instance_trs": {"position": trs["position"] + 0.01,
                         "rotation": trs["rotation"] + 0.01,
                         "scale": trs["scale"] * 1.005, "base_inv": trs["base_inv"]},
        "camera_pos": shift(cam.pos, [0.02, 0.01, 0.0]),
        "camera_target": shift(cam.target, [0.01, 0.0, 0.0])})
    return scene, cam, cfg, target, start
