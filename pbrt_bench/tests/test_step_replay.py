"""The reader of the share of train steps replayed from a recorded CUDA
graph (``step_replay_pct.inverse``) on synthetic span lists, as
``test_graph_replay.py`` reads the frames' share."""

from __future__ import annotations

import sys
import types

from pbrt_bench import harness
from pbrt_bench.tests.test_spans import Recorder, fake_run, spans

METRIC = "step_replay_pct.inverse"


def _read(recs, monkeypatch, iterations=4):
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace(spans=lambda: recs))
    return harness.load_module("metrics", METRIC).read(fake_run("step", iterations))


def _steps(*counts):
    rec = Recorder()
    for i, attrs in enumerate(counts):
        rec.step(100 * i)
        rec.recs[-4]["attrs"] = attrs
    return rec.recs


def test_share_of_replayed_steps(monkeypatch):
    """The first four steps are read: a warm-up, the recording, two replays
    (a fifth, replayed, is past the traced steps)."""
    recs = _steps({"replays": 0, "captures": 0}, {"replays": 1, "captures": 1},
                  {"replays": 1, "captures": 0}, {"replays": 1, "captures": 0},
                  {"replays": 1, "captures": 0})
    assert _read(recs, monkeypatch) == 75.0
    assert _read(recs[4:], monkeypatch) == 100.0


def test_eager_steps_read_zero(monkeypatch):
    recs = _steps({"replays": 0, "captures": 0}, {"replays": 0, "captures": 0})
    assert _read(recs, monkeypatch) == 0.0


def test_silent_on_a_program_without_the_counts(monkeypatch):
    assert _read(_steps({}, {}), monkeypatch) is None
    monkeypatch.setitem(sys.modules, spans.PROFILING, types.SimpleNamespace())
    assert harness.load_module("metrics", METRIC).read(fake_run("step")) is None
    assert harness.load_module("metrics", METRIC).read(fake_run("frame")) is None
