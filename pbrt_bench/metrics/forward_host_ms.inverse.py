"""Host wall time of the program's ``pbrt.forward`` span per traced step,
in ms: the parameters applied to the scene, the batch's render and the
loss."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "step", lambda t: spans.wall_ns(t, "pbrt.forward") / 1e6)
