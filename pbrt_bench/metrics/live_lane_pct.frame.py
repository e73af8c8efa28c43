"""Live lanes over lanes launched, in %, of the traversal launches (B1 and
B2, closest, occlusion and retest) in the traced frames, as the program
counts them at each launch (a lane is live where its range is positive)."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    ts = spans.trees(run, "frame")
    if not ts:
        return None
    lanes = sum(spans.total(t, "lanes") for t in ts)
    return None if lanes <= 0 else 100.0 * sum(spans.total(t, "live") for t in ts) / lanes
