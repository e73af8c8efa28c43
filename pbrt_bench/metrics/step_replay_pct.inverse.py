"""Train steps replayed from a recorded CUDA graph, in % of the traced
steps, as the program counts them in the attributes of its ``pbrt.step``
span (``replays``: 1 where the step replayed). A program that does not
count them gives None."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    steps = [r for t in spans.trees(run, "step") or () for r in t
             if r["name"] == "pbrt.step" and "replays" in r["attrs"]]
    if not steps:
        return None
    return 100.0 * sum(r["attrs"]["replays"] for r in steps) / len(steps)
