"""Runs one cell of the port's benchmark on the card and prints its result.

    python3 -m pbrt_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. A cell is ``workloads/<cell>.json`` (its
configuration, its traffic mix and the limits of its check); the
configuration is ``configs/<name>.json``, the traffic mix
``traffic/<name>.json``, which names its driver ``drivers/<kind>.py``; the
metrics the cell reports are those ``BENCHMARK.json`` lists for it, each
read by ``metrics/<metric>.py``.

The run: find the card (fail without one), make the inputs from the seed,
build and warm up (set-up), measure for ``--seconds`` (with ``--trace 1``
the first few iterations run under the profiler), read the peak memory,
free the program's state, run the check against the reference, and print
the compared numbers beside their limits on standard error and, as its
last line, one JSON object.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from pbrt_bench import harness

T0 = harness.process_start()


class Context:
    """One run's cell, configuration, traffic, seed and device."""

    def __init__(self, cell: str, seed: int, device, engine: dict | None = None,
                 render: dict | None = None):
        from pbrt_bench import scenes
        self.cell = cell
        self.spec = scenes.load_json("workloads", cell)
        self.cfg = scenes.load_json("configs", self.spec["config"])
        if render:
            self.cfg = dict(self.cfg, render=dict(self.cfg["render"], **render))
        self.traffic = scenes.load_json("traffic", self.spec["traffic"])
        self.limits = self.spec["limits"]
        self.seed = seed
        self.device = device
        self.engine = engine or {}
        self.inputs = scenes.scene_inputs(self.cfg)

    def driver(self):
        return harness.load_module("drivers", self.traffic["driver"]).Driver(self)


def _environment() -> None:
    """Caches inside the checkout; JAX kept out of libraries that could load it."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(harness.REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(harness.REPO / "build" / "torch_extensions")


def card_info(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    chips = next((w["chips"] for w in harness.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pbrt_bench: the cell needs {chips} CUDA device(s), PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; "
              "nothing is measured on the CPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    torch.cuda.init()
    return measure(args, torch.device("cuda", 0))


def measure(args, device) -> int:
    """The run after the card was found: set-up, window, check, result."""
    import torch
    from pbrt_bench import scenes
    from pbrt_bench.reference.integrator import QueryCount

    ctx = Context(args.workload, args.seed, device)
    drv = ctx.driver()
    torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    torch.cuda.synchronize(device)
    setup_s = time.time() - T0
    window, traced = harness.run_window(drv.iterate, args.seconds, drv.unit,
                                        ctx.traffic["trace_iterations"] if args.trace else 0)
    peak = torch.cuda.max_memory_allocated(device)
    drv.release()
    torch.cuda.empty_cache()
    t_parse = time.perf_counter()
    trace = harness.TraceSummary(*traced) if traced else None
    t_check = time.perf_counter()
    counts = QueryCount()
    checks = drv.check(counts)
    print(f"pbrt_bench {ctx.cell} seed {ctx.seed}: set-up {setup_s:.2f} s, {window.count} "
          f"{drv.unit}s in {window.seconds:.2f} s, trace read {t_check - t_parse:.2f} s, "
          f"check {time.perf_counter() - t_check:.2f} s, peak {peak / 2**30:.3f} GiB",
          file=sys.stderr)
    counted = None
    if counts.closest:
        n_checked = len(getattr(drv, "ticks", ())) * ctx.traffic["check"]["slots"]
        counted = {"closest_per_pixel": counts.closest / n_checked,
                   "any_per_pixel": counts.any / n_checked,
                   "triangles": scenes.triangle_count(ctx.inputs)}
        print(f"pbrt_bench {ctx.cell}: live queries per pixel, closest "
              f"{counted['closest_per_pixel']!r}, occlusion {counted['any_per_pixel']!r} "
              f"(reference, {n_checked} checked pixels)", file=sys.stderr)
    run = harness.Run(ctx.cfg, setup_s, window, trace, counted)
    bench = harness.benchmark()
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = harness.read_metrics(harness.cell_metrics(bench, ctx.cell, kind), run)
    device_info = dict(card_info(torch), memory_peak_bytes=int(peak))
    if trace is not None:
        device_info.update(busy_s=trace.busy_us / 1e6, window_s=trace.window_s)
    found = harness.forbidden_modules()
    if found:
        print(f"pbrt_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    correct = all(v <= lim for v, lim in checks.values())
    line = harness.result_line(correct, window, metrics, device_info, checks,
                               trace.breakdown() if trace is not None else None)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
