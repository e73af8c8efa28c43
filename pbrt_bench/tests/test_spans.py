"""The readers of the program's own spans (``metrics/spans.py`` and the nine
metrics that use it) on synthetic span lists."""

from __future__ import annotations

import sys
import types

import pytest

from pbrt_bench import harness

spans = harness.load_module("metrics", "spans")
FRAME_METRICS = ("closest_host_ms.frame", "occlusion_host_ms.frame", "shade_host_ms.frame",
                 "film_host_ms.frame", "host_reads.frame", "host_wait_ms.frame",
                 "live_lane_pct.frame")
STEP_METRICS = ("forward_host_ms.inverse", "backward_host_ms.inverse")
MS = 1_000_000


class Recorder:
    """Builds a span list as the program records it (parent positions, one
    tick id per tree); times in ms."""

    def __init__(self):
        self.recs = []
        self.tick = -1

    def add(self, name, start, end, parent=-1, **counts):
        if parent == -1:
            self.tick += 1
        rec = dict(name=name, parent=parent, tick=self.tick, start_ns=start * MS,
                   end_ns=end * MS, reads=0, wait_ns=0, lanes=0, live=0, attrs={})
        rec.update(counts)
        self.recs.append(rec)
        return len(self.recs) - 1

    def frame(self, t0, scale=1):
        """A tick of 100 ms * scale: two bounces, one with a shadow pass."""
        s = scale
        tick = self.add("pbrt.tick", t0, t0 + 100 * s)
        self.add("pbrt.closest", t0 + 1 * s, t0 + 11 * s, tick, lanes=100, live=100)
        shade = self.add("pbrt.shade", t0 + 11 * s, t0 + 41 * s, tick, reads=2,
                         wait_ns=1 * MS * s)
        self.add("pbrt.occlusion", t0 + 20 * s, t0 + 30 * s, shade, lanes=100, live=40)
        self.add("pbrt.closest", t0 + 41 * s, t0 + 51 * s, tick, lanes=100, live=60,
                 attrs={"depth": 1})
        self.add("pbrt.shade", t0 + 51 * s, t0 + 61 * s, tick, reads=1)
        self.add("pbrt.film", t0 + 70 * s, t0 + 99 * s, tick, reads=1, wait_ns=3 * MS * s)

    def step(self, t0, scale=1):
        s = scale
        step = self.add("pbrt.step", t0, t0 + 50 * s)
        fwd = self.add("pbrt.forward", t0 + 1 * s, t0 + 21 * s, step)
        self.add("pbrt.closest", t0 + 2 * s, t0 + 5 * s, fwd, lanes=10, live=10)
        self.add("pbrt.backward", t0 + 21 * s, t0 + 45 * s, step)


def fake_run(unit, iterations=2, traced=True):
    w = harness.Window(unit)
    w.durations, w.seconds = [1.0] * 10, 10.0
    trace = types.SimpleNamespace(iterations=iterations, host_iterations=iterations)
    return harness.Run({}, 1.0, w, trace if traced else None, None)


@pytest.fixture
def program(monkeypatch):
    """Installs a stand-in for the port's profiling module holding ``recs``."""
    def install(recs, with_spans=True):
        mod = types.SimpleNamespace(spans=lambda: [dict(r) for r in recs]) if with_spans \
            else types.SimpleNamespace()
        monkeypatch.setitem(sys.modules, spans.PROFILING, mod)
    return install


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_frame_metrics_read_the_first_trees(program):
    """Two card-only frames, then two host frames twice as slow: the readers
    take the first two trees only."""
    r = Recorder()
    for k in range(2):
        r.frame(1000 * k)
    for k in range(2, 4):
        r.frame(1000 * k, scale=2)
    program(r.recs)
    run = fake_run("frame")
    assert read("closest_host_ms.frame", run) == pytest.approx(20.0)
    assert read("occlusion_host_ms.frame", run) == pytest.approx(10.0)
    assert read("shade_host_ms.frame", run) == pytest.approx(30.0)    # 30 - 10 + 10
    assert read("film_host_ms.frame", run) == pytest.approx(29.0)
    assert read("host_reads.frame", run) == pytest.approx(4.0)
    assert read("host_wait_ms.frame", run) == pytest.approx(4.0)
    assert read("live_lane_pct.frame", run) == pytest.approx(100.0 * 200 / 300)
    for name in STEP_METRICS:
        assert read(name, run) is None


def test_host_subwindow_when_the_card_only_one_recorded_nothing(program):
    r = Recorder()
    for k in range(2):
        r.frame(1000 * k, scale=2)
    program(r.recs)
    assert read("closest_host_ms.frame", fake_run("frame")) == pytest.approx(40.0)


def test_step_metrics(program):
    r = Recorder()
    for k in range(6):
        r.step(100 * k, scale=1 if k < 4 else 3)
    program(r.recs)
    run = fake_run("step", iterations=4)
    assert read("forward_host_ms.inverse", run) == pytest.approx(20.0)
    assert read("backward_host_ms.inverse", run) == pytest.approx(24.0)
    for name in FRAME_METRICS:
        assert read(name, run) is None


@pytest.mark.parametrize("name", FRAME_METRICS + STEP_METRICS)
def test_nothing_to_read(program, name):
    """None, never an error: without a trace, without spans in the program
    (an older checkout), or with no tree recorded."""
    r = Recorder()
    r.frame(0)
    r.step(500)
    unit = "step" if name in STEP_METRICS else "frame"
    program(r.recs)
    assert read(name, fake_run(unit, traced=False)) is None
    program(r.recs, with_spans=False)
    assert read(name, fake_run(unit)) is None
    program([])
    assert read(name, fake_run(unit)) is None


def test_self_time_takes_out_children_only():
    r = Recorder()
    r.frame(0)
    tree = [dict(x, pos=i) for i, x in enumerate(r.recs)]
    assert spans.self_ns(tree, "pbrt.shade") == 30 * MS
    assert spans.self_ns(tree, "pbrt.tick") == (100 - 10 - 30 - 10 - 10 - 29) * MS
    assert spans.wall_ns(tree, "pbrt.closest") == 20 * MS
