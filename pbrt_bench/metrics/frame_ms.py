"""Time per progressive frame: the window's wall time over the frames it
completed (each frame a ``Renderer.tick``, ending in the film's fetch)."""


def read(run):
    w = run.window
    if w.unit != "frame" or not w.count:
        return None
    return 1e3 * w.seconds / w.count
