"""Device kernels launched per frame in the traced frames (memory copies
and fills left out): the integrator's dispatch."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.per_iteration(len(run.trace.kernels), "frame")
