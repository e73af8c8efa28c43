#!/usr/bin/env python3
"""Profile one bench frame of the PyTorch + CUDA port on the GPU, per engine.

    python3 profile_torch_frame.py [ENGINE ...]

ENGINE is any of bf16, f32, pallas_rows, wave, grad (default: the first
four, in that order). Renders the benchmark frame (bench scene, 1280x720,
4 bounces, AA, one shadow ray) with the default bf16 engine, then with the
exact f32 engine, then with the row-parallel exact engine
(``traversal="pallas_rows"``), then with the wave engine (``traversal="wave"``, on the scene's classic BVH): for
each, once to warm up, 3 times unprofiled (the median wall time: run it in
two checkouts in turns to compare frames), then once under
``torch.profiler``. Prints per engine the frame's wall times, the summed device time of all kernels and of the
traversal kernels (B2 ``traverse_bf16_kernel``, B1 ``traverse_kernel``, B3
``traverse_rows_kernel``, B4 ``leaf_mt_kernel``, the wave engine's
``wave_scan_kernel`` and its fused level ``wave_level_kernel``) with their
launch counts, the waves and levels the wave engine ran, the device-busy
share of the wall time and the kernel launch count, and the top 30
operators by device time. It also runs from an older checkout of the port
(copy it there), whose wave engine may lack the fused level.

ENGINE ``grad`` profiles the bench frame's gradient instead
(``chip_smoke.py`` phase 13a's problem: the L2 loss of the default bf16
frame at perturbed parameters, each chunk's backward before the next
chunk's forward): once to warm up, then once profiled with the forward
passes only (each chunk's graph dropped) and once profiled with the
backward passes too. Prints the device time of each, their difference (the
backward's), the peak memory, and the top 30 operators of the whole pass by
device time.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time


def _profile(label, scene, cam, cfg, dev, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer

    r = Renderer(scene, cam, cfg, device=dev)
    r.tick(0)
    torch.cuda.synchronize()
    plain_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        r.tick(0)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    traverse_packet.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.tick(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels: their own events where the profiler lists them, else
    # the kernels attached to the CPU operators that launched them
    evs = prof.events()
    kernels = [(e.name, e.device_time_total) for e in evs
               if e.device_type.name != "CPU"]
    if not kernels:
        kernels = [(k.name, k.duration) for e in evs for k in e.kernels]
    dev_ms = sum(t for _, t in kernels) / 1e3
    b2 = [t for n, t in kernels if "traverse_bf16_kernel" in n]
    b1 = [t for n, t in kernels if "traverse_kernel" in n and "bf16" not in n]
    b3 = [t for n, t in kernels if "traverse_rows_kernel" in n]
    b4 = [t for n, t in kernels if "leaf_mt_kernel" in n]
    scan = [t for n, t in kernels if "wave_scan_kernel" in n]
    level = [t for n, t in kernels if "wave_level_kernel" in n]
    # the wave engine's counts (an older checkout counts waves on the host only)
    waves = (traverse_packet.collect_waves() if hasattr(traverse_packet, "collect_waves")
             else dict(traverse_packet.WAVES))
    levels = dict(getattr(traverse_packet, "LEVELS", {}))
    print(f"card: {card}")
    print(f"frame 1280x720 {label}: unprofiled wall median {statistics.median(plain_ms):.2f} "
          f"ms over {[round(x, 2) for x in plain_ms]}")
    print(f"frame 1280x720 {label}: wall {wall_ms:.2f} ms, device "
          f"kernels {dev_ms:.2f} ms ({len(kernels)} launches), B2 {sum(b2) / 1e3:.2f} ms "
          f"({len(b2)} launches), B1 {sum(b1) / 1e3:.2f} ms ({len(b1)} launches), "
          f"B3 {sum(b3) / 1e3:.2f} ms ({len(b3)} launches), "
          f"B4 {sum(b4) / 1e3:.2f} ms ({len(b4)} launches), "
          f"scan {sum(scan) / 1e3:.2f} ms ({len(scan)} launches), "
          f"wave_level {sum(level) / 1e3:.2f} ms ({len(level)} launches), "
          f"waves {waves}, levels {levels}, "
          f"device busy {100 * dev_ms / wall_ms:.1f}%")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))


def _kernel_ms(prof):
    """(device ms summed over the profile's kernels, kernel count)."""
    evs = prof.events()
    kernels = [e.device_time_total for e in evs if e.device_type.name != "CPU"]
    if not kernels:
        kernels = [k.duration for e in evs for k in e.kernels]
    return sum(kernels) / 1e3, len(kernels)


def _profile_grad(cfg, dev, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _bench_grad_problem, _frame_grad
    from physically_based_ray_tracer_tpu_torch.diff.grad import apply_params, render_color

    scene, cam, target, params, chunk = _bench_grad_problem(dev, cfg)
    _frame_grad(scene, cam, cfg, params, target, chunk)
    n = cfg.n_pixels
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fwd:
        t0 = time.perf_counter()
        for c0 in range(0, n, chunk):
            s, c = apply_params(scene, cam, params)
            color = render_color(s, c, cfg, 0, 0, ids[c0:c0 + chunk])
            float(torch.sum((color - target[c0:c0 + chunk]) ** 2))
        torch.cuda.synchronize()
        fwd_wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as both:
        t0 = time.perf_counter()
        _frame_grad(scene, cam, cfg, params, target, chunk)
        torch.cuda.synchronize()
        both_wall = (time.perf_counter() - t0) * 1e3
    f_ms, f_n = _kernel_ms(fwd)
    b_ms, b_n = _kernel_ms(both)
    print(f"card: {card}")
    print(f"frame gradient 1280x720 bf16 ({-(-n // chunk)} chunks of {chunk}): forward "
          f"only: wall {fwd_wall:.2f} ms, device kernels {f_ms:.2f} ms ({f_n} launches); "
          f"forward + backward: wall {both_wall:.2f} ms, device kernels {b_ms:.2f} ms "
          f"({b_n} launches); backward's device time {b_ms - f_ms:.2f} ms "
          f"({b_n - f_n} launches); device busy {100 * b_ms / both_wall:.1f}%; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    print(both.key_averages().table(sort_by="self_device_time_total", row_limit=30))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    scene, cam, _ = build_bench_scene(legacy_bvh=True, device=dev)
    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, one_shadow_ray=True, chunk_pixels=65536)
    engines = {"bf16": cfg, "f32": cfg.replace(leaf_precision="f32"),
               "pallas_rows": cfg.replace(traversal="pallas_rows"),
               "wave": cfg.replace(traversal="wave")}
    for label in sys.argv[1:] or engines:
        if label == "grad":
            _profile_grad(cfg, dev, card)
        else:
            _profile(label, scene, cam, engines[label], dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
