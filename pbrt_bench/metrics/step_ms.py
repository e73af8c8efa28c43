"""Time per inverse-rendering step: the window's wall time over the steps
it completed (each step's loss read on the host)."""


def read(run):
    w = run.window
    if w.unit != "step" or not w.count:
        return None
    return 1e3 * w.seconds / w.count
