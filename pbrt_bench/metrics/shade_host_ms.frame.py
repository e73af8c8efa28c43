"""Host self time of the program's ``pbrt.shade`` spans per traced frame,
in ms: each bounce's post-hit block (gates, refine, materials, lights,
continuation) with its ``pbrt.occlusion`` children taken out."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.self_ns(t, "pbrt.shade") / 1e6)
