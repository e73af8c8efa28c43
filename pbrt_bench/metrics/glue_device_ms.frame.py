"""Device time of every kernel but the traversal kernels per traced frame,
in ms: shading, RNG, sorts, gathers and the wrappers' glue."""

from pbrt_bench.harness import load_module


def read(run):
    if run.trace is None:
        return None
    is_traversal = load_module("metrics", "traversal").is_traversal
    us = run.trace.kernel_us(lambda n: not is_traversal(n))
    return None if us <= 0 else run.per_iteration(us / 1e3, "frame")
