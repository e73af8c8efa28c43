"""Host wall time of the program's ``pbrt.backward`` span per traced step,
in ms: autograd's backward of the loss, to the gradients' completion on
the host side."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "step", lambda t: spans.wall_ns(t, "pbrt.backward") / 1e6)
