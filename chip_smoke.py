#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``physically_based_ray_tracer_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. It builds the
port's traversal kernel from
``physically_based_ray_tracer_tpu_torch/csrc/traverse_f32.cu`` (into
``build/torch_kernels/``), then:

1. probe: prints the toolchain, the card (nvidia-smi name, power limit) and
   the kernel build time;
2. kernel vs plain: on the benchmark scene (two-level, as flatten="auto"
   builds it, and flattened to one level) and three 131,072-ray sets
   (primary rays of an AA-doubled chunk of pixels drawn over the whole
   frame, bounce-like rays from surface
   points, shadow rays with finite tmax, ~20% of them 0) it holds the
   kernel's closest and occlusion results against the plain PyTorch
   version: equal found masks, t within 1e-6 relative, equal prim/instance
   except where the plain version sees a t-tie (a second candidate within
   1e-6 relative), equal occlusion masks, no truncated ray;
3. times: median of 10 CUDA-event runs of the kernel and of the plain
   version on the 131,072-ray sets (two-level table), and of the kernel
   alone on the one-level table;
4. main path: ``Renderer`` on the benchmark frame (1280x720, 4 bounces,
   AA, NEE with one shadow ray, f32 engine): one warm-up and 3 timed
   ``tick``s, launch counts (closest and any > 0, plain version 0), a finite
   image; then one chunk of 4096 pixels drawn over the frame, rendered on
   the GPU (kernel) and on the
   CPU (plain version) with the same key must agree on >= 99% of pixels
   within rtol=2e-4, atol=2e-5 (the two devices' transcendental functions
   differ in the last bits, and a t-tie may pick another triangle);
5. prints the kernels' JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_RAYS = 131072
KERNEL_SRC = "physically_based_ray_tracer_tpu_torch/csrc/traverse_f32.cu"
REPLACES = "physically_based_ray_tracer_tpu/ops/pallas_trace.py:102"
T_RTOL = 1e-6


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _ray_sets(scene, cam, cfg, dev, seed=0):
    """Three (o, d, tmax) sets of N_RAYS rays on ``dev``."""
    import torch
    from physically_based_ray_tracer_tpu_torch import EPSILON
    from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays
    from physically_based_ray_tracer_tpu_torch.utils import rng
    from physically_based_ray_tracer_tpu_torch.utils.rng import Purpose

    far = torch.full((N_RAYS,), 1e30, dtype=torch.float32, device=dev)
    gen = np.random.default_rng(seed)
    # primary: an AA-doubled chunk of N_RAYS/2 pixels drawn over the whole
    # frame (sky, floor and spheres), in the main path's Morton order
    ids = torch.from_numpy(_frame_pixels(cfg, N_RAYS // 2, gen)).to(dev)
    xs = torch.remainder(ids, cfg.width).float()
    ys = torch.div(ids, cfg.width, rounding_mode="floor").float()
    j = rng.uniform2(0, ids, 0, 0, Purpose.AA_JITTER)
    o1, d1 = primary_rays(cam, xs, ys, cfg.width, cfg.height)
    o2, d2 = primary_rays(cam, xs + j[:, 0], ys + j[:, 1], cfg.width, cfg.height)
    primary = (torch.cat([o1, o2]).contiguous(), torch.cat([d1, d2]).contiguous(), far)

    P = scene.n_prims

    def surface_points():
        prim = torch.from_numpy(gen.integers(0, P, N_RAYS)).to(dev)
        uv = gen.uniform(0, 1, (N_RAYS, 2))
        flip = uv.sum(1) > 1
        uv[flip] = 1 - uv[flip]
        uv = torch.from_numpy(uv.astype(np.float32)).to(dev)
        p = (scene.tri_v0[prim] + uv[:, :1] * scene.tri_e1[prim]
             + uv[:, 1:] * scene.tri_e2[prim])
        return p, scene.face_normal[prim]

    p, n = surface_points()
    d = torch.nn.functional.normalize(
        torch.from_numpy(gen.normal(size=(N_RAYS, 3)).astype(np.float32)).to(dev), dim=1)
    d = torch.where((d * n).sum(1, keepdim=True) < 0, -d, d)
    bounce = ((p + d * EPSILON).contiguous(), d.contiguous(), far)

    p, n = surface_points()
    L = scene.lights
    targets = torch.cat([L.point_pos, L.dir_pos, L.spot_pos])
    tgt = targets[torch.from_numpy(gen.integers(0, targets.shape[0], N_RAYS)).to(dev)]
    lvec = tgt - p
    dist = lvec.norm(dim=1)
    d = lvec / dist[:, None]
    tmax = torch.where(torch.from_numpy(gen.uniform(0, 1, N_RAYS) < 0.2).to(dev),
                       torch.zeros_like(dist), dist - EPSILON)
    shadow = ((p + d * EPSILON).contiguous(), d.contiguous(), tmax.contiguous())
    return {"primary": primary, "bounce": bounce, "shadow": shadow}


def _frame_pixels(cfg, n, gen) -> np.ndarray:
    """``n`` distinct pixel ids of the frame, in Morton order."""
    from physically_based_ray_tracer_tpu_torch.render.renderer import morton_pixel_order
    order = morton_pixel_order(cfg.width, cfg.height)
    pick = np.sort(gen.choice(order.shape[0], n, replace=False))
    return order[pick]


def _plain_hit(dbvh, o, d, tm):
    """Plain version mapped like the kernel wrapper, plus its tie mask."""
    from physically_based_ray_tracer_tpu_torch.ops import trace
    *raw, t2 = trace.plain_traverse(dbvh, o, d, tm, closest=True)
    hit = trace.to_hit(dbvh, *raw)
    found = hit.prim >= 0
    tie = found & (t2 <= raw[0] * (1 + T_RTOL))
    return found, hit.t, hit.prim, hit.inst, tie


def _compare(name, dbvh, o, d, tm, report):
    """Kernel (through the main path's sorted wrappers) vs plain version."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace
    hit = trace.sorted_closest_dense(dbvh, o, d, tm)
    occ_k = trace.sorted_any_dense(dbvh, o, d, tm)
    found_p, t_p, prim_p, inst_p, tie = _plain_hit(dbvh, o, d, tm)
    occ_p = trace.plain_traverse(dbvh, o, d, tm, closest=False)
    torch.cuda.synchronize()
    found_k = hit.prim >= 0
    both = found_k & found_p
    rel = ((hit.t - t_p).abs() / t_p.abs().clamp(min=1e-30))[both]
    same = both & ~tie
    r = dict(
        found=int(found_p.sum()), found_mismatch=int((found_k != found_p).sum()),
        ties=int(tie.sum()),
        t_max_rel=float(rel.max()) if rel.numel() else 0.0,
        t_max_abs=float((hit.t - t_p).abs()[same].max()) if same.any() else 0.0,
        prim_mismatch=int(((hit.prim != prim_p) & same).sum()),
        inst_mismatch=int(((hit.inst != inst_p) & same).sum()),
        occluded=int(occ_p.sum()), occ_mismatch=int((occ_k != occ_p).sum()))
    print(f"  {name}: {json.dumps(r)}", flush=True)
    report.append(r)
    _check(r["found_mismatch"] == 0, f"{name}: found masks differ")
    _check(r["t_max_rel"] <= T_RTOL, f"{name}: t differs by {r['t_max_rel']}")
    _check(r["prim_mismatch"] == 0 and r["inst_mismatch"] == 0,
           f"{name}: prim/inst differ outside t-ties")
    _check(r["occ_mismatch"] == 0, f"{name}: occlusion masks differ")


def _time_ms(fn, runs=10):
    """Median over ``runs`` of one call timed by CUDA events, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.ops import _build, trace
    from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    reference = [m for m in sys.modules if m.split(".")[0]
                 in ("jax", "jaxlib", "physically_based_ray_tracer_tpu")]
    _check(not reference, f"the port imported {reference}")
    dev = torch.device("cuda", 0)
    card = _smi()
    print(f"card: {card}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_INFO['path']})", flush=True)
    print(_build.BUILD_INFO["log"], flush=True)

    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, traversal="pallas", leaf_precision="f32",
                       one_shadow_ray=True, chunk_pixels=65536)
    t0 = time.perf_counter()
    scene2, cam, _ = build_bench_scene(flatten="auto", device=dev)
    scene1, _, _ = build_bench_scene(flatten=True, device=dev)
    print(f"scenes built in {time.perf_counter() - t0:.1f} s: two-level "
          f"{scene2.dense.n_nodes} nodes / {scene2.dense.n_groups} groups / "
          f"{scene2.dense.n_instances} instances (stack need "
          f"{scene2.dense.stack_need}); one-level {scene1.dense.n_nodes} nodes / "
          f"{scene1.dense.n_groups} groups (stack need {scene1.dense.stack_need})",
          flush=True)
    _check(scene2.dense.two_level and not scene1.dense.two_level,
           "flatten='auto' must keep the bench scene two-level")

    # 2. kernel vs plain
    report = []
    sets = _ray_sets(scene2, cam, cfg, dev)
    for tname, sc in (("two-level", scene2), ("one-level", scene1)):
        for sname, (o, d, tm) in sets.items():
            _compare(f"{tname}/{sname}", sc.dense, o, d, tm, report)
    trunc = trace.truncated_rays(dev)
    print(f"truncated rays: {trunc}", flush=True)
    _check(trunc == 0, f"{trunc} rays hit the step bound or the stack cap")

    # 3. times at the main path's shapes (rays co-sorted as the main path
    # does): kernel and plain version on the main path's two-level table,
    # the kernel alone on the flattened one-level table
    times = {}
    for sname, (o, d, tm) in sets.items():
        for tname, sc in (("two-level", scene2), ("one-level", scene1)):
            dbvh = sc.dense
            _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
            for mode in ("closest", "any"):
                closest = mode == "closest"
                if closest:
                    kfn = lambda: trace.intersect_closest_dense(dbvh, o_s, d_s, tm_s)
                else:
                    kfn = lambda: trace.intersect_any_dense(dbvh, o_s, d_s, tm_s)
                k_ms = _time_ms(kfn)
                line = f"time {mode:7s} {sname:7s} {N_RAYS} rays, {tname}: kernel {k_ms:.4f} ms"
                if tname == "two-level":
                    p_ms = _time_ms(lambda: trace.plain_traverse(dbvh, o_s, d_s, tm_s, closest))
                    times[(sname, mode)] = (k_ms, p_ms)
                    line += f", plain {p_ms:.2f} ms"
                print(f"{line} [{card}]", flush=True)

    # 4. the main path
    renderer = Renderer(scene2, cam, cfg, device=dev)
    trace.reset_counts()
    t0 = time.perf_counter()
    renderer.tick(0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    frame_ms = []
    img = None
    for _ in range(3):
        t0 = time.perf_counter()
        img = renderer.tick(0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(trace.LAUNCHES)
    plain_calls = sum(trace.PLAIN_CALLS.values())
    print(f"frame 1280x720 4 bounces AA f32: warm-up {warm:.2f} s, median "
          f"{statistics.median(frame_ms):.2f} ms over {frame_ms} [{card}]", flush=True)
    print(f"main path (4 frames): kernel launches {launches}, plain-version "
          f"calls {plain_calls}", flush=True)
    _check(launches["closest"] > 0 and launches["any"] > 0,
           "the main path did not launch both kernel modes")
    _check(plain_calls == 0, "the main path called the plain version")
    _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
           "image not finite or of the wrong shape")
    print(f"image finite, mean {float(img.mean()):.6f}", flush=True)
    trunc = trace.truncated_rays(dev)
    _check(trunc == 0, f"{trunc} rays truncated on the main path")

    ids = torch.from_numpy(_frame_pixels(cfg, 4096, np.random.default_rng(1))).to(dev)
    c_gpu, t_gpu = render_sample(renderer.scene, renderer.camera, cfg, 0, 0, ids)
    cpu_scene = renderer.scene.to("cpu")
    t0 = time.perf_counter()
    c_cpu, t_cpu = render_sample(cpu_scene, renderer.camera.to("cpu"), cfg, 0, 0,
                                 ids.cpu())
    close = np.isclose(c_gpu.cpu().numpy(), c_cpu.numpy(), rtol=2e-4,
                       atol=2e-5).all(axis=1)
    print(f"4096-pixel chunk, kernel (GPU) vs plain (CPU, {time.perf_counter() - t0:.1f} s):"
          f" {close.mean() * 100:.3f}% pixels allclose, mean abs diff "
          f"{float((c_gpu.cpu() - c_cpu).abs().mean()):.3e}", flush=True)
    _check(close.mean() >= 0.99, "kernel and plain chunk images disagree")

    # 5. result lines
    def err(mode):
        if mode == "closest":
            return max(r["t_max_abs"] for r in report)
        return float(any(r["occ_mismatch"] for r in report))   # boolean output

    kernels = [{"name": f"traverse_f32_{mode}", "route": "cuda", "source": KERNEL_SRC,
                "replaces": REPLACES, "launches": launches[mode],
                "max_abs_err": err(mode),
                "ms": times[(sname, mode)][0], "plain_ms": times[(sname, mode)][1]}
               for mode, sname in (("closest", "bounce"), ("any", "shadow"))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
