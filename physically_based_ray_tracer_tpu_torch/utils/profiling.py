"""Profiling helpers, spans and counters; counterpart of
``physically_based_ray_tracer_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace of a block (the card's kernels
too, where there is a card) and writes it as a Chrome trace (view it in
ui.perfetto.dev or chrome://tracing), with the program's spans made inside
the block on a host track of their own; ``stopwatch`` prints a block's host
time, the device's queue drained at the end.

The program's spans and counters:

* ``annotate(name, **attrs)`` is a span, used as a context manager or (by
  name alone) as a decorator. Tracing is on exactly while a torch profiler
  records (``torch.autograd._profiler_enabled()``). Off, ``annotate``
  returns the span name's shared no-op context: no record, no clock read.
  On, a span appends a record to a bounded buffer (``CAP`` records;
  ``dropped()`` counts the spans the cap turned away): its name, the index
  of its parent span (-1 for a root), the id of the tree it belongs to
  (``tick``: one id for all spans of one frame or step), its start and end
  on the Unix clock (``time.time_ns``, the clock the profiler stamps its
  own events on), the counters below and ``attrs``. A span never goes
  through ``torch.profiler.record_function``: with the card traced, the
  profiler reports each such range as a device event of its own.
* ``host_read(site, x)`` is the one way the frame's and the step's paths
  read device data on the host. It counts the read in ``READS[site]``
  (always) and, while a span is open, adds it to the innermost open span's
  ``reads`` and the host time blocked in it to its ``wait_ns``.
* ``add_attrs(**attrs)`` adds counts to the innermost open span's
  ``attrs`` (the train step's ``pbrt.backward`` gets ``take_rows`` and
  ``take_rows_rows``: the row gather's backward calls, each one kernel
  launch on the card, and the rows they reduced).
* ``count_lanes(t_max)`` is called on every dense traversal launch (the
  kernel and the plain version alike): while a span is open, it adds the
  launch's lanes to the innermost open span's ``lanes`` and its live lanes
  (``t_max > 0``, summed on the device, so no sync) to its ``live``.
* ``count_reset(slots, kept)`` is called on every film update: while a span
  is open, it adds the update's film slots to the innermost open span's
  ``slots`` and the slots that went on with their running mean (``kept``,
  summed on the device, so no sync) to its count of kept slots; its
  ``reset`` is the difference, the slots whose running mean restarted.

``paused()`` turns all of it off for a block, whatever the profiler does:
no span, no count in a span (``READS`` still counts). Code recorded into
a CUDA graph runs inside it, so that no device sum of a counter and no
host read is recorded with it.

``spans()`` returns the records as dicts, with ``live`` and ``reset`` read
back from the device (a sync: call it after the work); ``reset()`` clears
the buffer and the counts. One process has one stack of open spans: the
frame and the step run on one thread.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time

import torch

TRACE_FILE = "trace.json"
CAP = 1 << 16                   # records kept until reset()
READS: dict[str, int] = {}      # host reads of device data, per site

_FIELDS = ("name", "parent", "tick", "start_ns", "end_ns", "reads", "wait_ns",
           "lanes", "live", "slots", "attrs")
_DEVICE_SUMS = ("live", "kept")     # record lists holding device scalars until spans()
_records: list["_Record"] = []
_open: list["_Record | None"] = []      # open spans, innermost last (None: dropped)
_state = {"dropped": 0, "ticks": 0, "paused": 0}


class _Record:
    __slots__ = _FIELDS + ("index", "kept")


class _NoSpan:
    """A span while tracing is off: a no-op, shared by every use of one name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


_NO_SPANS: dict[str, _NoSpan] = {}


class _Span:
    """A span while tracing is on: a record appended at entry (unless the
    buffer is full), its end stamped at exit."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        if len(_records) >= CAP:
            _state["dropped"] += 1
            _open.append(None)
            return None
        parent = _innermost()
        rec = _Record()
        rec.name, rec.attrs, rec.index = self.name, self.attrs, len(_records)
        rec.parent = -1 if parent is None else parent.index
        if parent is None:
            rec.tick = _state["ticks"]
            _state["ticks"] += 1
        else:
            rec.tick = parent.tick
        rec.reads = rec.wait_ns = rec.lanes = rec.slots = 0
        rec.live = []
        rec.kept = []
        rec.end_ns = None
        _records.append(rec)
        _open.append(rec)
        rec.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        rec = _open.pop()
        if rec is not None:
            rec.end_ns = time.time_ns()
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


def _decorated(name: str, fn):
    """``fn`` in a span of ``name``, decided at each call."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)
    return inner


def _innermost() -> "_Record | None":
    """The innermost open span that holds a record (None while paused)."""
    if _state["paused"]:
        return None
    for rec in reversed(_open):
        if rec is not None:
            return rec
    return None


def annotate(name: str, **attrs):
    """The program's span ``name`` around a block (a context manager), or
    around each call of a function (a decorator; then by name alone).
    ``attrs`` (e.g. ``depth``) are kept in the record. Records only while a
    torch profiler records; see the module docstring."""
    if _state["paused"] or not torch.autograd._profiler_enabled():
        off = _NO_SPANS.get(name)
        if off is None:
            off = _NO_SPANS[name] = _NoSpan(name)
        return off
    return _Span(name, attrs)


def host_read(site: str, x: torch.Tensor):
    """``x`` on the host: a Python scalar for a 0-d tensor, else a numpy
    array. Counted in ``READS[site]``, and while a span is open in its
    ``reads`` and ``wait_ns`` (the host time the read blocked)."""
    READS[site] = READS.get(site, 0) + 1
    rec = _innermost()
    t0 = time.time_ns() if rec is not None else 0
    out = x.item() if x.dim() == 0 else x.cpu().numpy()
    if rec is not None:
        rec.wait_ns += time.time_ns() - t0
        rec.reads += 1
    return out


@contextlib.contextmanager
def paused():
    """No span opens and no span counts inside the block (see the module
    docstring)."""
    _state["paused"] += 1
    try:
        yield
    finally:
        _state["paused"] -= 1


def add_attrs(**attrs) -> None:
    """``attrs`` added to the innermost open span's record (nothing while
    tracing is off)."""
    rec = _innermost()
    if rec is not None:
        rec.attrs = dict(rec.attrs, **attrs)


def count_lanes(t_max: torch.Tensor) -> None:
    """One traversal launch over ``t_max``'s lanes (live where t_max > 0),
    added to the innermost open span."""
    rec = _innermost()
    if rec is not None:
        rec.lanes += t_max.shape[0]
        rec.live.append((t_max > 0).sum())


def count_reset(slots: int, kept: torch.Tensor | None = None) -> None:
    """One film update over ``slots`` slots, of which ``kept`` (a bool mask
    on the device; None: none) went on with their running mean and the
    rest restarted, added to the innermost open span."""
    rec = _innermost()
    if rec is not None:
        rec.slots += slots
        if kept is not None:
            rec.kept.append(kept.sum())


def spans() -> list[dict]:
    """The records, in the order the spans opened, as dicts of ``_FIELDS``
    and ``reset`` (``slots`` less the kept slots), ``live`` summed to an
    int: the device's counts are read back here, in one transfer per
    device, and kept as ints."""
    pending: dict[torch.device, list] = {}
    for rec in _records:
        for counts in (getattr(rec, k) for k in _DEVICE_SUMS):
            for i, x in enumerate(counts):
                if isinstance(x, torch.Tensor):
                    pending.setdefault(x.device, []).append((counts, i))
    for where in pending.values():
        values = torch.stack([counts[i] for counts, i in where]).tolist()
        for (counts, i), v in zip(where, values):
            counts[i] = int(v)
    return [dict({k: getattr(rec, k) for k in _FIELDS},
                 live=sum(rec.live), reset=rec.slots - sum(rec.kept))
            for rec in _records]


def dropped() -> int:
    """Spans the cap turned away since the last ``reset()``."""
    return _state["dropped"]


def reset() -> None:
    """Clear the span buffer, its dropped count and ``READS``."""
    _records.clear()
    _state["dropped"] = 0
    READS.clear()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record everything inside the block (host operations, and the card's
    kernels when PyTorch sees a card) and write it to
    ``<log_dir>/trace.json`` at the end, with the program's spans recorded
    inside the block as complete events of a host track ("pbrt spans") on
    the trace's own time base; yields ``log_dir`` (by default
    ``pbrt_torch_trace`` in the temporary directory)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pbrt_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    first = len(_records)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _merge_spans(path, spans()[first:])


def _merge_spans(path: str, recs: list[dict]) -> None:
    """Add ``recs`` (closed spans) to the Chrome trace at ``path`` as
    complete events on a track of their own. The export's timestamps are
    microseconds after its ``baseTimeNanoseconds`` on the Unix clock."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), 0
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "pbrt spans"}})
    for r in recs:
        if r["end_ns"] is None:
            continue
        args = dict(r["attrs"], tick=r["tick"], reads=r["reads"], wait_us=r["wait_ns"] / 1e3,
                    lanes=r["lanes"], live=r["live"], slots=r["slots"], reset=r["reset"])
        events.append({"ph": "X", "cat": "pbrt_span", "name": r["name"], "pid": pid,
                       "tid": tid, "ts": (r["start_ns"] - base) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def stopwatch(label: str, sink=print):
    """Host wall time of the block, after the card has finished the work
    queued inside it (a device sync at exit, where CUDA is in use)."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
