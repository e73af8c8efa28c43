"""Host reads of device scalars per frame in the traced frames (the
``aten::_local_scalar_dense`` ops behind the integrator's ``any()`` gates)."""


def read(run):
    if run.trace is None:
        return None
    syncs = run.trace.op_counts.get("aten::_local_scalar_dense", 0)
    return run.per_iteration(syncs, "frame", host=True)
