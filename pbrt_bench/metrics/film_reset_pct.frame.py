"""Film slots whose running mean restarted, in % of the slots updated, over
the traced frames, as the program counts them at each film update (a slot
restarts where its primary-hit distance moved by EPSILON or more). A
program that does not count them gives None."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    recs = [r for t in spans.trees(run, "frame") or () for r in t]
    slots = sum(r.get("slots", 0) for r in recs)
    return None if slots <= 0 else 100.0 * sum(r.get("reset", 0) for r in recs) / slots
