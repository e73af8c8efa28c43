"""Device time per traced step of the kernels launched under autograd's
backward (host ops below an ``autograd::engine::evaluate_function``), in ms."""


def read(run):
    if run.trace is None or run.trace.backward_us <= 0:
        return None
    return run.per_iteration(run.trace.backward_us / 1e3, "step", host=True)
