"""Host wall time of the program's ``pbrt.closest`` spans per traced frame,
in ms: each bounce's closest-hit pass (co-sort, engine dispatch, kernel
launch, winner decode)."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.wall_ns(t, "pbrt.closest") / 1e6)
