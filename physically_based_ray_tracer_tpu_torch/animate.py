"""Dynamic-scene demo: the per-frame loop move instances -> refresh the
TLAS (``rebuild_scene``) -> render; counterpart of ``examples/animate.py``.

Renders ``--frames`` frames of four spheres orbiting over a heavy static
mesh on the two-level layout and times, per frame, the incremental
``rebuild_scene`` refresh against a from-scratch ``build_scene_instanced``
of the same instances (each on the host clock, ending in a device sync).
The summary JSON goes to ``--json-out`` or, without it, to stdout; frames
go to ``--frames-out`` as PNGs if asked for.

    python -m physically_based_ray_tracer_tpu_torch.animate [--frames 8] [--size 96]
        [--frames-out DIR] [--json-out PATH] [--cpu]

It renders on the CUDA card; ``--cpu`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
from physically_based_ray_tracer_tpu_torch.scene.procedural import make_sphere
from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance, MeshModel,
                                                               build_scene_instanced,
                                                               rebuild_scene)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.image import write_png


def make_scene(device=DEFAULT_DEVICE):
    """(models, lights, camera): a small sphere that moves and a heavy
    static mesh (the refresh's gain grows with the share of geometry that
    stays put)."""
    device = resolve(device)
    sphere = MeshModel.from_fat(make_sphere(radius=0.5, lat=16, lon=24),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4,
                                metalness=0.2)
    floor = MeshModel.from_fat(
        make_sphere(center=(0.0, -5.0, 0.0), radius=4.3, lat=96, lon=192),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]], device=device).pad_points(4)
    cam = Camera.make(pos=(0, 2.5, 6), target=(0, 0, 0), device=device)
    return [sphere, floor], lights, cam


def orbit(t: float, n: int = 4, radius: float = 2.0, model: int = 0) -> list[Instance]:
    """``n`` instances of ``model`` evenly spaced on a circle of ``radius``
    about the y axis at angle ``t``, bobbing in y (``examples/animate.py``'s
    motion: its ``instances_at`` is ``orbit(t) + [the static mesh]``)."""
    out = []
    for k in range(n):
        a = t + k * 2 * np.pi / n
        out.append(Instance(model, position=(radius * np.cos(a),
                                             0.3 + 0.2 * np.sin(2 * a),
                                             radius * np.sin(a))))
    return out


def instances_at(t: float) -> list[Instance]:
    return orbit(t) + [Instance(1)]       # + the static mesh


def run(frames: int = 8, size: int = 96, frames_out: str | None = None,
        device=DEFAULT_DEVICE) -> dict:
    """Render ``frames`` frames; returns the summary (medians in ms)."""
    device = resolve(device)
    models, lights, cam = make_scene(device)
    scene, handle, depth = build_scene_instanced(models, instances_at(0.0), lights,
                                                 legacy_bvh=False, device=device)
    cfg = RenderConfig(width=size, height=size, bounces=2, antialias=False,
                       skybox=False, max_stack_depth=max(depth + 2, 32))
    r = Renderer(scene, cam, cfg, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    refresh_ms, full_ms, frame_ms = [], [], []
    for f in range(frames):
        insts = instances_at(2 * np.pi * f / frames)
        t0 = time.perf_counter()
        r.scene = rebuild_scene(r.scene, handle, insts, device=device)
        sync()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        build_scene_instanced(models, insts, lights, legacy_bvh=False, device=device)
        sync()
        full_ms.append((time.perf_counter() - t0) * 1e3)
        r.reset_accumulation()           # the scene moved: start the film anew
        img = r.tick(0)
        frame_ms.append(r.stats.frame_ms)
        if frames_out:
            os.makedirs(frames_out, exist_ok=True)
            write_png(os.path.join(frames_out, f"animate_{f:03d}.png"), img)
        print(f"frame {f}: refresh {refresh_ms[-1]:.1f} ms, full build "
              f"{full_ms[-1]:.1f} ms, render {frame_ms[-1]:.1f} ms", file=sys.stderr)
    return {
        "frames": frames,
        "moved_instances_per_frame": 4,
        "static_instances": 1,
        "device": str(device),
        "refresh_ms_median": float(np.median(refresh_ms)),
        "full_build_ms_median": float(np.median(full_ms)),
        "frame_ms_median": float(np.median(frame_ms)),
        "speedup": float(np.median(full_ms) / max(np.median(refresh_ms), 1e-9)),
        "note": "rebuild_scene = O(instances) TLAS head + O(moved tris) "
                "shading re-bake vs from-scratch two-level build",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--frames-out", default=None)
    ap.add_argument("--json-out", default=None,
                    help="write the summary JSON here (default: stdout)")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = ap.parse_args(argv)
    out = run(args.frames, args.size, args.frames_out,
              device="cpu" if args.cpu else DEFAULT_DEVICE)
    text = json.dumps(out, indent=2)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
