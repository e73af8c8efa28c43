"""The reader of the share of frame chunks replayed from a recorded CUDA
graph (``graph_replay_pct.frame``) on synthetic span lists, as
``test_spans.py`` reads the other span metrics."""

from __future__ import annotations

import sys
import types

from pbrt_bench import harness
from pbrt_bench.tests.test_spans import Recorder, fake_run, spans

METRIC = "graph_replay_pct.frame"


def _read(recs, monkeypatch, iterations=2):
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace(spans=lambda: recs))
    return harness.load_module("metrics", METRIC).read(fake_run("frame", iterations))


def _ticks(*counts):
    rec = Recorder()
    for i, attrs in enumerate(counts):
        rec.frame(200 * i)
        rec.recs[-7]["attrs"] = attrs
    return rec.recs


def test_share_of_replayed_chunks(monkeypatch):
    recs = _ticks({"chunks": 15, "replays": 15, "captures": 0, "refreshed": 0},
                  {"chunks": 15, "replays": 10, "captures": 1, "refreshed": 0},
                  {"chunks": 15, "replays": 0, "captures": 0, "refreshed": 0})
    assert _read(recs, monkeypatch) == 100.0 * 25 / 30


def test_eager_ticks_read_zero(monkeypatch):
    recs = _ticks({"chunks": 2, "replays": 0, "captures": 0, "refreshed": 0},
                  {"chunks": 2, "replays": 0, "captures": 0, "refreshed": 0})
    assert _read(recs, monkeypatch) == 0.0


def test_silent_on_a_program_without_the_counts(monkeypatch):
    assert _read(_ticks({}, {}), monkeypatch) is None
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace())
    assert harness.load_module("metrics", METRIC).read(fake_run("frame")) is None
    assert harness.load_module("metrics", METRIC).read(fake_run("step")) is None
