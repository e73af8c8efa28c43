"""Profiling helpers; counterpart of
``physically_based_ray_tracer_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace of a block (the card's kernels
too, where there is a card) and writes it as a Chrome trace (view it in
ui.perfetto.dev or chrome://tracing); ``annotate`` names a span in it;
``stopwatch`` prints a block's host time, the device's queue drained at the
end.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record everything inside the block (host operations, and the card's
    kernels when PyTorch sees a card) and write it to
    ``<log_dir>/trace.json`` at the end; yields ``log_dir`` (by default
    ``pbrt_torch_trace`` in the temporary directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pbrt_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named span in ``trace``'s output (a context manager or decorator)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stopwatch(label: str, sink=print):
    """Host wall time of the block, after the card has finished the work
    queued inside it (a device sync at exit, where CUDA is in use)."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
