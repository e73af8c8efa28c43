"""Share of the traced frames' wall time in which no device activity ran
(the union of kernel and copy intervals, against the host clock)."""


def read(run):
    t = run.trace
    if t is None or run.window.unit != "frame" or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / 1e6 / t.window_s)
