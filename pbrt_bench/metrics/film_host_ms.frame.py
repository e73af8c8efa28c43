"""Host wall time of the program's ``pbrt.film`` span per traced frame, in
ms: the tick's tail after its last chunk (the film's update, the fetch of
the frame to the host, the display image)."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.wall_ns(t, "pbrt.film") / 1e6)
