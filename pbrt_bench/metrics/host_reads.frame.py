"""Host reads of device data per traced frame, counted by the program
(``host_read``) over the frame's span tree: the integrator's gates, the
bf16 engine's retest gate and the film's fetch."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.total(t, "reads"))
