"""Command-line renderer; counterpart of ``physically_based_ray_tracer_tpu/cli.py``.

Usage:
    python -m physically_based_ray_tracer_tpu_torch.cli --demo sphere --out out.png
    python -m physically_based_ray_tracer_tpu_torch.cli --demo cornell --spp 64
    python -m physically_based_ray_tracer_tpu_torch.cli --assets /path/to/assets \
        --scene scene1 --width 1920 --height 1080

The flags and defaults are the JAX package's. It renders on the CUDA card;
``--cpu`` renders on the CPU instead (the kernels' plain versions). Each
frame's time and Mrays/s go to stderr, the written path to stdout. The
editing session (``--session``), the pixel debugger (``--debug-pixel``)
and the BVH overlay (``--draw-bvh``) are not ported: asking for one exits
with status 2 and a message naming it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

NOT_PORTED = {"session": "--session (the headless edit session)",
              "debug_pixel": "--debug-pixel (the per-pixel path debugger)",
              "draw_bvh": "--draw-bvh (the BVH wireframe overlay)"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Path tracer (PyTorch + CUDA port)")
    p.add_argument("--demo", choices=["sphere", "cornell"], default=None,
                   help="procedural demo scene")
    p.add_argument("--assets", default=None, help="reference-format assets root")
    p.add_argument("--scene", default="scene1", help="scene directory name")
    p.add_argument("--out", default=None, help="output PNG (default: timestamped)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=8, help="accumulated frames")
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--aov", default="BRDF",
                   help="render mode: BRDF|BASECOLOR|GEOMETRYNORMAL|SHADINGNORMAL|"
                        "METAL|ROUGHNESS|EMMISIVE|DEPTH|PRIMID")
    p.add_argument("--no-aa", action="store_true")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--no-lights", action="store_true")
    p.add_argument("--no-normal-map", action="store_true")
    p.add_argument("--no-stochastic", action="store_true")
    p.add_argument("--post", action="store_true", help="Panini + vignette + aberration")
    p.add_argument("--post-preset", type=int, default=2, choices=(1, 2),
                   help="named post chain preset: 1 = wide-fov Panini + warm "
                        "grade + strong vignette + aberration; 2 = engine defaults")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU instead of the CUDA card")
    p.add_argument("--debug-pixel", nargs=2, type=int, metavar=("X", "Y"),
                   default=None, help="not ported: exits with status 2")
    p.add_argument("--draw-bvh", type=int, default=None, metavar="LEVEL",
                   help="not ported: exits with status 2")
    p.add_argument("--session", action="store_true",
                   help="not ported: exits with status 2")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    asked = [msg for key, msg in NOT_PORTED.items()
             if getattr(args, key) not in (None, False)]
    if asked:
        print(f"not ported to the PyTorch package: {', '.join(asked)}; use "
              "the JAX package's command line for it", file=sys.stderr)
        return 2

    import torch

    from physically_based_ray_tracer_tpu_torch.config import RenderConfig, RenderMode
    from physically_based_ray_tracer_tpu_torch.ops.tonemap import POST_PRESETS
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE

    device = "cpu" if args.cpu else DEFAULT_DEVICE
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        rendering_mode=RenderMode[args.aov],
        antialias=not args.no_aa, gamma_corrected=not args.no_gamma,
        skybox=not args.no_skybox, lighted=not args.no_lights,
        normal_mapped=not args.no_normal_map,
        stochastic_lights=not args.no_stochastic,
        post_processed=args.post, post_preset=args.post_preset)

    if args.demo == "cornell":
        from physically_based_ray_tracer_tpu_torch.scene.presets import cornell_box
        scene, cam = cornell_box(device=device)
    elif args.demo == "sphere" or args.assets is None:
        from physically_based_ray_tracer_tpu_torch.scene.presets import sphere_demo
        scene, cam = sphere_demo(device=device)
    else:
        from physically_based_ray_tracer_tpu_torch.scene.loader import load_reference_scene
        scene, cam, _ = load_reference_scene(args.assets, args.scene, device=device)

    if args.post:
        # the preset's fov / distortion drive the Panini projection
        pp = POST_PRESETS.get(args.post_preset, POST_PRESETS[2])
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=cam.fov.device)
        cam = dataclasses.replace(cam, fov=f32(pp["fov"]),
                                  distortion=f32(pp["distortion"]))

    r = Renderer(scene, cam, cfg, device=device)
    t0 = time.time()
    for s in range(args.spp):
        r.tick(args.seed)
        print(f"frame {s + 1}/{args.spp}: {r.stats.frame_ms:.1f} ms, "
              f"{r.stats.mrays_per_s:.1f} Mrays/s", file=sys.stderr)
    out = r.capture(args.out)
    print(f"wrote {out} ({args.spp} spp, {time.time() - t0:.1f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
