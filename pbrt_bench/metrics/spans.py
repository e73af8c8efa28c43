"""The program's own spans (``utils/profiling.py`` of the port), shared by
the readers of per-layer host times and counts.

The records are taken through ``sys.modules``: the run has imported the
port (``port.load``), and a traced run's profiler turned its spans on.
Each record has a name, the position of its parent in the list (-1 for a
root), its tree's id (``tick``), ``start_ns`` / ``end_ns`` on the host clock, ``reads`` and
``wait_ns`` (host reads of device data inside it), ``lanes`` and ``live``
(traversal lanes launched inside it, and those live). The records form one
tree per frame (root ``pbrt.tick``) or step (root ``pbrt.step``). A reader
uses the first ``run.trace.iterations`` trees: those of the sub-window
that records the card alone, where the profiler adds least host time, or,
where that sub-window recorded no spans, the next sub-window's. A program
without spans (no ``spans()``, or no tree) gives None."""

from __future__ import annotations

import sys

PROFILING = "physically_based_ray_tracer_tpu_torch.utils.profiling"
ROOTS = {"frame": "pbrt.tick", "step": "pbrt.step"}


def records() -> list[dict]:
    """The program's records, each with its position in the list (``pos``)."""
    spans = getattr(sys.modules.get(PROFILING), "spans", None)
    return [dict(r, pos=i) for i, r in enumerate(spans())] if callable(spans) else []


def trees(run, unit: str) -> list[list[dict]] | None:
    """The records of each of the first ``run.trace.iterations`` trees of a
    run of ``unit`` (frame or step), in order; None without any, or in a
    run of another unit."""
    if run.trace is None or run.window.unit != unit:
        return None
    root = ROOTS[unit]
    recs = records()
    ticks = [r["tick"] for r in recs if r["parent"] == -1 and r["name"] == root]
    ticks = ticks[:run.trace.iterations]
    if not ticks:
        return None
    return [[r for r in recs if r["tick"] == t] for t in ticks]


def wall_ns(tree: list[dict], name: str) -> int:
    """Summed wall time of the tree's spans named ``name``."""
    return sum(r["end_ns"] - r["start_ns"] for r in tree if r["name"] == name)


def self_ns(tree: list[dict], name: str) -> int:
    """Summed self time of the tree's spans named ``name``: their wall time
    less that of their children (which run one after another)."""
    own = {r["pos"] for r in tree if r["name"] == name}
    kids = sum(r["end_ns"] - r["start_ns"] for r in tree if r["parent"] in own)
    return wall_ns(tree, name) - kids


def total(tree: list[dict], key: str) -> int:
    """``key`` (a counter) summed over the tree."""
    return sum(r[key] for r in tree)


def per_tree(run, unit: str, value):
    """The mean over the trees of a run of ``unit`` of ``value(tree)``; None
    without trees."""
    ts = trees(run, unit)
    if not ts:
        return None
    return sum(value(t) for t in ts) / len(ts)
