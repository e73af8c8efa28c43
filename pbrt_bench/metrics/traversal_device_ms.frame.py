"""Device time of the dense traversal kernels (B1 ``traverse_kernel``, B2
``traverse_bf16_kernel``) per traced frame, in ms."""

from pbrt_bench.harness import load_module


def read(run):
    if run.trace is None:
        return None
    is_traversal = load_module("metrics", "traversal").is_traversal
    us = run.trace.kernel_us(is_traversal)
    return None if us <= 0 else run.per_iteration(us / 1e3, "frame")
