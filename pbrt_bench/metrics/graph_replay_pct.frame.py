"""Frame chunks replayed from a recorded CUDA graph, in % of the chunks
rendered, over the traced frames, as the program counts them in the
attributes of its ``pbrt.tick`` span (``replays`` and ``chunks``). A
program that does not count them gives None."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    ticks = [r for t in spans.trees(run, "frame") or () for r in t if r["name"] == "pbrt.tick"]
    chunks = sum(r["attrs"].get("chunks", 0) for r in ticks)
    if chunks <= 0:
        return None
    return 100.0 * sum(r["attrs"].get("replays", 0) for r in ticks) / chunks
