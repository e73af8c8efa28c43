"""Host wall time of the program's ``pbrt.occlusion`` spans per traced
frame, in ms: each shadow-ray pass (co-sort, engine dispatch, kernel
launch; on the bf16 engine its retest of the uncertain lanes)."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.wall_ns(t, "pbrt.occlusion") / 1e6)
