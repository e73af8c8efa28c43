"""Host wall time of the program's ``pbrt.rebuild`` span per traced frame,
in ms: the tick's scene refresh before its chunks (the moved instances'
re-bake, their scatter into the shading arrays and the TLAS rebuild). A
program without the span gives None."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    ts = spans.trees(run, "frame")
    if not ts or not any(r["name"] == "pbrt.rebuild" for t in ts for r in t):
        return None
    return sum(spans.wall_ns(t, "pbrt.rebuild") for t in ts) / len(ts) / 1e6
