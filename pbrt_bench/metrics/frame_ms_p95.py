"""The 95th percentile of every frame's time in the window (host clock,
each frame ending in the film's fetch to the host)."""

from pbrt_bench.harness import percentile


def read(run):
    w = run.window
    if w.unit != "frame" or not w.count:
        return None
    return 1e3 * percentile(w.durations, 95.0)
