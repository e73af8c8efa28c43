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
``torch.profiler``. Prints per engine the frame's wall times, the waves and
levels the wave engine ran, the program's spans of the profiled frame
(``utils/profiling.spans``: per span name its count, wall and self time,
host reads and the time blocked in them, traversal lanes launched and
live), the host reads by site (``profiling.READS``), and the top 30
operators by device time. The device's busy share
and the traversal kernels' times are the benchmark's
(``python3 -m pbrt_bench.run ... --trace 1``). It also runs from an older
checkout of the port (copy it there), which may lack the spans or the
wave engine's fused level.

ENGINE ``grad`` profiles the bench frame's gradient instead
(``chip_smoke.py`` phase 13a's problem: the L2 loss of the default bf16
frame at perturbed parameters, each chunk's backward before the next
chunk's forward): once to warm up, then once profiled with the forward
passes only (each chunk's graph dropped) and once profiled with the
backward passes too. Prints the device time of each, their difference (the
backward's), the peak memory, the program's spans of the whole pass and the
top 30 operators of the whole pass by device time.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time


def span_table(recs: list[dict]) -> str:
    """Per span name (in first-seen order): count, wall and self ms (self:
    less the wall time of its children), host reads and ms blocked in them,
    traversal lanes launched and live."""
    rows: dict[str, list] = {}
    for r in recs:
        row = rows.setdefault(r["name"], [0, 0, 0, 0, 0, 0, 0])
        wall = r["end_ns"] - r["start_ns"]
        row[0] += 1
        row[1] += wall
        row[2] += wall
        row[3:] = [row[3] + r["reads"], row[4] + r["wait_ns"], row[5] + r["lanes"],
                   row[6] + r["live"]]
        if r["parent"] >= 0:
            rows[recs[r["parent"]]["name"]][2] -= wall
    out = [f"{'span':<16}{'count':>7}{'wall ms':>11}{'self ms':>11}{'reads':>7}"
           f"{'wait ms':>10}{'lanes':>12}{'live':>12}"]
    for name, (n, wall, own, reads, wait, lanes, live) in rows.items():
        out.append(f"{name:<16}{n:>7}{wall / 1e6:>11.2f}{own / 1e6:>11.2f}{reads:>7}"
                   f"{wait / 1e6:>10.2f}{lanes:>12}{live:>12}")
    return "\n".join(out)


def _spans():
    """The program's spans since the last reset, and a reset; an older
    checkout without spans gives none."""
    from physically_based_ray_tracer_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return []
    recs = profiling.spans()
    profiling.reset()
    return recs


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
    _spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.tick(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the wave engine's counts (an older checkout counts waves on the host only)
    waves = (traverse_packet.collect_waves() if hasattr(traverse_packet, "collect_waves")
             else dict(traverse_packet.WAVES))
    levels = dict(getattr(traverse_packet, "LEVELS", {}))
    print(f"card: {card}")
    print(f"frame 1280x720 {label}: unprofiled wall median {statistics.median(plain_ms):.2f} "
          f"ms over {[round(x, 2) for x in plain_ms]}; profiled wall {wall_ms:.2f} ms, "
          f"waves {waves}, levels {levels}")
    from physically_based_ray_tracer_tpu_torch.utils import profiling
    reads = dict(getattr(profiling, "READS", {}))
    print(span_table(_spans()))
    # a full-width frame reads the film's fetch alone; shade tiles add their
    # slices' alive_in / found0, ring resharding its live counts
    print(f"host reads by site: {reads}")
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
    _spans()
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
          f"({b_n - f_n} launches); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    print(span_table(_spans()))
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
