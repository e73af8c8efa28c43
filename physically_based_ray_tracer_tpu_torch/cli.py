"""Command-line renderer; counterpart of ``physically_based_ray_tracer_tpu/cli.py``.

Usage:
    python -m physically_based_ray_tracer_tpu_torch.cli --demo sphere --out out.png
    python -m physically_based_ray_tracer_tpu_torch.cli --demo cornell --spp 64
    python -m physically_based_ray_tracer_tpu_torch.cli --assets /path/to/assets \
        --scene scene1 --width 1920 --height 1080
    python -m physically_based_ray_tracer_tpu_torch.cli --demo cornell --debug-pixel 640 360
    python -m physically_based_ray_tracer_tpu_torch.cli --demo cornell --draw-bvh 3
    python -m physically_based_ray_tracer_tpu_torch.cli --assets ROOT --session < commands

The flags and defaults are the JAX package's. It renders on the CUDA card;
``--cpu`` renders on the CPU instead (the kernels' plain versions). Each
frame's time and Mrays/s go to stderr, the written path to stdout.
``--debug-pixel X Y`` prints one pixel's per-bounce trace and the colour
grid around it instead of rendering a frame; ``--draw-bvh LEVEL`` draws the
boxes of one level of the scene's classic BVH over the capture;
``--session`` runs the headless edit session over ``--assets`` (stdin
commands: move / light / cam / render / capture / watch / quit).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


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
                   default=None,
                   help="print a per-bounce trace of one pixel's path plus its "
                        "neighbourhood colour grid instead of rendering a frame")
    p.add_argument("--draw-bvh", type=int, default=None, metavar="LEVEL",
                   help="overlay the BVH node AABB wireframes of the given tree "
                        "level on the capture")
    p.add_argument("--session", action="store_true",
                   help="headless edit session over --assets: stdin commands "
                        "(move/light/cam/render/capture/watch/quit) change the "
                        "live scene and write the scene JSONs back")
    return p


def run_session(args, cfg, device) -> None:
    """The stdin-driven edit-render loop (``session.EditSession``). A bad
    command prints an error and the session goes on."""
    from physically_based_ray_tracer_tpu_torch.session import EditSession

    s = EditSession(args.assets, args.scene, cfg=cfg, device=device)
    print("session ready; commands: move NAME X Y Z | light KIND IDX "
          "pos|color X Y Z | cam PX PY PZ [TX TY TZ] | render [SPP] | "
          "capture [PATH] | watch | quit", file=sys.stderr)
    for line in sys.stdin:
        try:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "quit":
                break
            elif tok[0] == "move":
                s.edit_object(tok[1], position=[float(x) for x in tok[2:5]])
            elif tok[0] == "light":
                kw = {"pos": "position", "color": "color"}[tok[3]]
                s.edit_light(tok[1], int(tok[2]), **{kw: [float(x) for x in tok[4:7]]})
            elif tok[0] == "cam":
                v = [float(x) for x in tok[1:]]
                s.edit_camera(pos=v[:3], target=v[3:6] if len(v) >= 6 else None)
            elif tok[0] == "render":
                s.render(samples=int(tok[1]) if len(tok) > 1 else 1)
                print(f"rendered: {s.renderer.stats.frame_ms:.1f} ms", file=sys.stderr)
            elif tok[0] == "capture":
                print("wrote", s.capture(tok[1] if len(tok) > 1 else None))
            elif tok[0] == "watch":
                print("changed:", s.watch_once(), file=sys.stderr)
            else:
                print(f"unknown command: {tok[0]}", file=sys.stderr)
        except Exception as e:  # keep the session alive on bad input
            print(f"error: {e}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
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

    if args.session:
        if args.assets is None:
            print("--session requires --assets", file=sys.stderr)
            return 2
        run_session(args, cfg, device)
        return 0

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

    if args.debug_pixel is not None:
        from physically_based_ray_tracer_tpu_torch.render.debugger import (
            format_trace, pixel_grid, trace_pixel)
        x, y = args.debug_pixel
        print(format_trace(trace_pixel(scene, cam, cfg, x, y, device=device)))
        grid = pixel_grid(scene, cam, cfg, x, y, device=device)
        with np.printoptions(precision=3, suppress=True):
            print(f"colour grid around ({x},{y}):\n{grid}")
        return 0

    if args.draw_bvh is not None and scene.bvh is None:
        print("--draw-bvh: the scene has no classic BVH (build it with "
              "legacy_bvh=True)", file=sys.stderr)
        return 2
    r = Renderer(scene, cam, cfg, device=device)
    t0 = time.time()
    for s in range(args.spp):
        r.tick(args.seed)
        print(f"frame {s + 1}/{args.spp}: {r.stats.frame_ms:.1f} ms, "
              f"{r.stats.mrays_per_s:.1f} Mrays/s", file=sys.stderr)
    if args.draw_bvh is not None:
        from physically_based_ray_tracer_tpu_torch.utils.debug_draw import (
            bvh_level_boxes, draw_aabbs)
        from physically_based_ray_tracer_tpu_torch.utils.image import write_png
        lo, hi = bvh_level_boxes(scene.bvh.nodes_box.cpu().numpy(),
                                 scene.bvh.nodes_child.cpu().numpy(), args.draw_bvh)
        img = draw_aabbs(r._current_image(), cam, lo, hi)
        out = write_png(args.out or f"capture_{int(time.time())}.png", img)
        print(f"wrote {out} with BVH level-{args.draw_bvh} overlay ({lo.shape[0]} boxes)")
        return 0
    out = r.capture(args.out)
    print(f"wrote {out} ({args.spp} spp, {time.time() - t0:.1f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
