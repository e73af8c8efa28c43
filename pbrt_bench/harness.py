"""The benchmark's machinery, shared by every cell: finding a cell's files
by name, the measured window, the profiler's summary of a traced
sub-window, the metric readers, the check for forbidden modules and the
result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from bisect import bisect_right
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "physically_based_ray_tracer_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
PEAK_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def process_start() -> float:
    """The process's start on the ``time.time`` clock (from /proc where it
    exists, else now)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by file name (a
    metric's name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"pbrt_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those that
    list it, and those that list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Window:
    """Iteration times of the measured window."""

    def __init__(self, unit: str):
        self.unit = unit
        self.durations: list[float] = []
        self.seconds = 0.0

    @property
    def count(self) -> int:
        return len(self.durations)


def run_window(iterate, seconds: float, unit: str, profile_iters: int = 0):
    """Call ``iterate`` (one frame or step, ending synchronised with the
    card) until ``seconds`` have passed; the last call ends past the mark.
    With ``profile_iters``, the first that many run under the profiler
    recording the card alone (little host overhead: the device's busy time
    and its wall window), the next that many under the profiler recording
    host ops too (syncs, autograd's backward, what the host did in the
    gaps). Returns (Window, the two (profiler, wall seconds, iterations), or
    None)."""
    w = Window(unit)
    traced = []
    t_start = time.perf_counter()
    if profile_iters:
        import torch
        from torch.profiler import ProfilerActivity, profile, supported_activities
        card = [a for a in supported_activities() if a == ProfilerActivity.CUDA]
        for acts in (card or [ProfilerActivity.CPU], [ProfilerActivity.CPU] + card):
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(profile_iters):
                    t1 = time.perf_counter()
                    iterate()
                    w.durations.append(time.perf_counter() - t1)
                torch.cuda.synchronize()
                traced.append((prof, time.perf_counter() - t0, profile_iters))
    while time.perf_counter() - t_start < seconds:
        t1 = time.perf_counter()
        iterate()
        w.durations.append(time.perf_counter() - t1)
    w.seconds = time.perf_counter() - t_start
    return w, traced or None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_events(evs):
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end) for e in evs
            if e.device_type == DeviceType.CUDA]


class TraceSummary:
    """What the readers take from a traced run's two sub-windows. From the
    one recording the card alone: every device activity (name, start, end
    in us), the kernel subset, the busy time (their union) and the wall
    window. From the one recording host ops too: host op counts, the device
    time of kernels launched under autograd's backward, and the longest idle
    gaps named by the host op running through them."""

    BACKWARD = "autograd::engine::evaluate_function"

    def __init__(self, device_trace, host_trace):
        from torch.autograd import DeviceType
        prof, self.window_s, self.iterations = device_trace
        self.device = _device_events(prof.events())
        self.kernels = [x for x in self.device
                        if not x[0].startswith(("Memcpy", "Memset"))]
        self.busy_us = sum(b - a for a, b in _merge([(a, b) for _, a, b in self.device]))
        prof, _, self.host_iterations = host_trace
        evs = prof.events()
        cpu = [e for e in evs if e.device_type == DeviceType.CPU]
        self.op_counts: dict[str, int] = {}
        for e in cpu:
            self.op_counts[e.name] = self.op_counts.get(e.name, 0) + 1
        self.backward_us = 0.0
        for e in cpu:
            if not e.kernels:
                continue
            p = e
            while p is not None and not p.name.startswith(self.BACKWARD):
                p = p.cpu_parent
            if p is not None:
                self.backward_us += sum(k.duration for k in e.kernels)
        self.gaps = self._name_gaps(_merge([(a, b) for _, a, b in _device_events(evs)]), cpu)

    @staticmethod
    def _name_gaps(merged, cpu):
        """The ten longest gaps between device activity, each named by the
        innermost host op running through its middle (profiler and CUDA
        runtime records left out), or else by the op that ended last
        before it."""
        ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                      if not e.name.startswith(("ProfilerStep", "Activity Buffer", "cuda"))),
                     key=lambda x: x[0])
        starts = [o[0] for o in ops]
        gaps = sorted(((b2 - a2, a2, b2) for (_, a2), (b2, _) in zip(merged, merged[1:])),
                      reverse=True)[:10]
        named = []
        for length, a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect_right(starts, mid) - 1
            name, last_end, last = None, -1.0, "nothing"
            for j in range(i, max(i - 2000, -1), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
                if ops[j][1] > last_end:
                    last_end, last = ops[j][1], ops[j][2]
            named.append([name or f"after {last}", length / 1e6])
        return named

    def kernel_us(self, match=None) -> float:
        return sum(b - a for n, a, b in self.kernels if match is None or match(n))

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, a, b in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": self.gaps}


class Run:
    """What a metric reader is given: the configuration, the set-up time,
    the window, the traced sub-window's summary (traced runs) and what the
    check counted."""

    def __init__(self, cfg, setup_s, window, trace, counted):
        self.cfg = cfg
        self.setup_s = setup_s
        self.window = window
        self.trace = trace
        self.counted = counted

    def per_iteration(self, value: float, unit: str, host: bool = False):
        """``value`` over the traced iterations (of the sub-window that
        recorded host ops, with ``host``), if the traced unit is ``unit``."""
        if self.trace is None or self.window.unit != unit:
            return None
        return value / (self.trace.host_iterations if host else self.trace.iterations)


def read_metrics(entries: list[dict], run: Run) -> dict:
    """Each entry's reader on ``run``; a reader that finds nothing is left out."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def result_line(correct: bool, window: Window, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The run's last line: the contract's keys, then ``checks`` last (each
    compared number beside its limit)."""
    out = {"correct": bool(correct), "attempted": window.count, "failed": 0,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)
