"""Inverse rendering demo: recover a material and a light from a target
image; counterpart of ``examples/inverse_material.py``.

Renders a target image of the sphere demo scene, perturbs the material
albedo and roughness and the point lights' intensity, then recovers them
by gradient descent (Adam) on the pixel loss.

    python -m physically_based_ray_tracer_tpu_torch.inverse_material [--steps 200]
        [--size 64] [--device cuda]

It runs on the CUDA card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import render_color
from physically_based_ray_tracer_tpu_torch.diff.inverse import fit
from physically_based_ray_tracer_tpu_torch.scene.presets import sphere_demo
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

LR = 0.02


def problem(size: int = 64, device=DEFAULT_DEVICE):
    """(scene, camera, cfg, pixel_ids, target, wrong): the sphere demo at
    ``size`` x ``size``, its sample-0 image (key 0) and the perturbed start
    (albedo x 0.3 + 0.4, roughness + 0.25 clipped to [0.05, 1], point
    colour x 0.5)."""
    device = resolve(device)
    scene, cam = sphere_demo(device=device)
    cfg = RenderConfig(width=size, height=size, bounces=2, antialias=False,
                       skybox=False, gamma_corrected=False, max_stack_depth=32)
    pixel_ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=device)
    with torch.no_grad():
        target = render_color(scene, cam, cfg, 0, 0, pixel_ids)
    wrong = {"base_color": scene.mat_base * 0.3 + 0.4,
             "roughness": torch.clamp(scene.mat_rough + 0.25, 0.05, 1.0),
             "point_color": scene.lights.point_color * 0.5}
    return scene, cam, cfg, pixel_ids, target, wrong


def run(steps: int = 200, size: int = 64, device=DEFAULT_DEVICE, verbose: bool = True):
    """Fit the perturbed parameters for ``steps`` steps (lr 0.02, sample 0
    every step); returns (scene, params, losses)."""
    scene, cam, cfg, pixel_ids, target, wrong = problem(size, device)
    params, losses = fit(scene, cam, cfg, wrong, target, pixel_ids, steps=steps,
                         lr=LR, vary_sample=False, verbose=verbose)
    return scene, params, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    scene, params, losses = run(args.steps, args.size, args.device)
    host = lambda x: x.detach().cpu().numpy()
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
    print("recovered albedo (model 0):", np.round(host(params["base_color"])[0], 3),
          "true:", np.round(host(scene.mat_base)[0], 3))
    print("recovered roughness:", np.round(host(params["roughness"]), 3),
          "true:", np.round(host(scene.mat_rough), 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
