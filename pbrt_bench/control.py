"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's.

    python3 -m pbrt_bench.control --workload <cell> --seeds 11,12,13 --seconds 5 [--control]

On the card. Each seed runs the cell's set-up, a short window at the
cell's own load and the check, as a run does, in one process. With
``--control`` the control takes the program's place: for a
bf16 cell (and the inverse cell) the reference itself, computed in
bfloat16; for the f32 cell the program's own lower path, its bf16 engine.
Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pbrt_bench import harness
from pbrt_bench.drivers import frames, inverse
from pbrt_bench.reference import geometry, integrator
from pbrt_bench.reference.integrator import QueryCount
from pbrt_bench.run import Context


class _Film:
    def __init__(self, accum, spp, dist):
        self.accum, self.spp, self.dist = accum, spp, dist


def control_frames(ctx, dtype=torch.bfloat16) -> dict:
    """The reference in ``dtype`` in the program's place: the warm-up tick
    and one more, over the slots the check draws, then the check."""
    render = ctx.cfg["render"]
    w, h, bounces = render["width"], render["height"], render["bounces"]
    n = w * h
    n_slots = ctx.traffic["check"]["slots"]
    slots = np.union1d(frames.slot_sample(n, n_slots, ctx.seed, 0),
                       frames.slot_sample(n, n_slots, ctx.seed, 1))
    order = integrator.morton_order(w, h)
    dev = ctx.device
    low = geometry.bake(ctx.inputs, dev, dtype)
    s = torch.from_numpy(slots).to(dev)
    ids = torch.from_numpy(order[slots]).to(dev)
    film = _Film(torch.zeros((n, 3), device=dev), torch.zeros(n, device=dev),
                 torch.full((n,), -1.0, device=dev))
    ticks = []
    for sample in range(2):
        with torch.no_grad():
            color, t = integrator.render_sample(low, ids, ctx.seed, sample, w, h, bounces)
            accum, spp, dist, avg = integrator.film_update(
                film.accum[s], film.spp[s], film.dist[s], color.float(), t.float())
        after = _Film(film.accum.clone(), film.spp.clone(), film.dist.clone())
        after.accum[s], after.spp[s], after.dist[s] = accum, spp, dist
        img = np.zeros((n, 3), np.float32)
        img[order[slots]] = torch.clamp(avg, 0.0, 1.0).cpu().numpy()
        ticks.append((sample, film, after, img.reshape(h, w, 3)))
        film = after
    ref = geometry.bake(ctx.inputs, dev)
    off, total = frames.compare_ticks(ref, render, ctx.seed, ticks, n_slots)
    return {"pixels_off": (off / total, ctx.limits["pixels_off"])}


def control_steps(ctx, dtype=torch.bfloat16) -> dict:
    """The reference in ``dtype`` in the program's place for the first
    steps, against the reference in float32."""
    t = ctx.traffic
    start = inverse.perturb(inverse.true_params(ctx.inputs), t["start"])
    target = inverse.target_image(ctx)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    n = ctx.cfg["render"]["width"] * ctx.cfg["render"]["height"]
    batches = [torch.randperm(n, generator=gen, device=ctx.device)[:t["batch_pixels"]]
               for _ in range(t["warm_steps"])]
    got = inverse.reference_steps(ctx, start, batches, target, dtype)
    ref = inverse.reference_steps(ctx, start, batches, target)
    return inverse.compare_steps(got, ref, ctx.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pbrt_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(args.workload, seed, dev)
        kind = "program"
        if args.control and ctx.traffic["driver"] == "inverse":
            checks, kind = control_steps(ctx), "control: reference in bfloat16"
        elif args.control and ctx.traffic["engine"]["leaf_precision"] == "bf16":
            checks, kind = control_frames(ctx), "control: reference in bfloat16"
        else:
            if args.control:
                ctx.engine = {"leaf_precision": "bf16"}
                kind = "control: the program's bf16 engine"
            drv = ctx.driver()
            drv.setup()
            harness.run_window(drv.iterate, args.seconds, drv.unit)
            drv.release()
            checks = drv.check(QueryCount())
        print(json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                          "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
