"""Host time blocked in the program's reads of device data per traced
frame, in ms, over the frame's span tree: what the gates and the fetch
waited for the card."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    return spans.per_tree(run, "frame", lambda t: spans.total(t, "wait_ns") / 1e6)
