"""The game cell (``game-bf16-moving``): its seeded motion, its run at a tiny
size on the CPU, the faults and the control that its check must catch,
its metric readers and its place in ``BENCHMARK.json``."""

from __future__ import annotations

import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

from pbrt_bench import control, harness, scenes
from pbrt_bench.drivers import moving
from pbrt_bench.reference.integrator import QueryCount
from pbrt_bench.run import Context
from pbrt_bench.tests import test_layout
from pbrt_bench.tests.bench_fixtures import SEED, card, tiny_run  # noqa: F401 (fixture)

CELL = "game-bf16-moving"
SEEDS = (0, 7, SEED, 2**31 + 11, 2**32 + 5)
MIN_STEP = 0.03         # m a tick, far beyond the check's distance tolerance
SHADING = ("tri_v0", "tri_e1", "tri_e2", "face_normal", "corner_normal")


class _Stale(moving.Driver):
    """Each tick rendered on the previous tick's poses (the refresh one
    tick late)."""

    def poses(self, k):
        return super().poses(k - 1)


class _Unbaked(moving.Driver):
    """Each tick's TLAS refreshed over the shading arrays as they were."""

    def iterate(self):
        self.k += 1
        r = self.renderer
        before, sample = r.film, r.sample
        old = r.scene
        moved = self.mods["scene.scene"].rebuild_scene(old, r.handle, self.poses(self.k),
                                                       device=self.ctx.device)
        r.scene = dataclasses.replace(moved, **{k: getattr(old, k) for k in SHADING})
        img = r.tick(self.key)
        self.last = (self.k, sample, before, r.film, img)


FAULTS = {"stale": _Stale, "unbaked": _Unbaked, "bf16": None}


def _reading(ctx, fault, iterations=2):
    """The check's numbers with a fault in the program's place: the cell's
    set-up, ``iterations`` ticks and the check; for ``bf16`` the reference
    in bfloat16 in the program's place (``pbrt_bench.control``)."""
    if FAULTS[fault] is None:
        return control.control_frames(ctx)
    drv = FAULTS[fault](ctx)
    drv.setup()
    for _ in range(iterations):
        drv.iterate()
    drv.release()
    return drv.check(QueryCount())


def _motion(seed):
    ctx = Context(CELL, seed, torch.device("cpu"))
    return ctx, moving.Motion(ctx.inputs["instances"], ctx.traffic["motion"], seed)


def _positions(motion, ticks):
    return np.array([[p["position"] for p in motion.poses(k)] for k in ticks])


@pytest.mark.parametrize("seed", SEEDS)
def test_motion_deterministic_bounded_moving(seed):
    ctx, motion = _motion(seed)
    _, again = _motion(seed)
    ticks = range(0, 3000)
    pos = _positions(motion, ticks)
    assert np.array_equal(pos, _positions(again, ticks))
    assert [p["rotation"] for p in motion.poses(17)] == [p["rotation"] for p in again.poses(17)]
    spheres, floor = motion.moving, [9]
    assert spheres == list(range(9))
    bound = ctx.traffic["motion"]["bound"]
    assert np.abs(pos[:, spheres][..., [0, 2]]).max() <= bound
    assert pos[:, spheres, 1].min() >= 0.0          # a unit sphere's bottom on the floor at -1
    assert pos[:, spheres, 1].max() <= 2.0 + 1e-9   # the highest apex
    assert np.array_equal(pos[:, floor], np.zeros_like(pos[:, floor]))
    step = np.linalg.norm(np.diff(pos[:, spheres], axis=0), axis=-1)
    assert step.min() >= MIN_STEP
    horizontal = np.linalg.norm(np.diff(pos[:, spheres][..., [0, 2]], axis=0), axis=-1)
    assert horizontal.max() <= 3.0 / 30 * 1.01
    assert not np.array_equal(_positions(_motion(seed + 1)[1], [5]), pos[[5]])


def test_sound_run_correct():
    drv, checks, counts = tiny_run(CELL, 16, 9, iterations=2)
    off, limit = checks["pixels_off"]
    assert off <= limit
    assert [t[0] for t in drv.ticks] == [1, 3]
    assert counts.closest > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_caught(fault):
    """A tick on the previous tick's scene, a refreshed TLAS over shading
    arrays left un-baked, and the reference in bfloat16 in the program's
    place all read above the limit."""
    ctx = Context(CELL, SEED, torch.device("cpu"),
                  render={"width": 16, "height": 9, "chunk_pixels": 64})
    ctx.traffic = dict(ctx.traffic, check={"slots": 144})
    off, limit = _reading(ctx, fault)["pixels_off"]
    assert off > limit


def test_parent_without_instances_fails_at_once(monkeypatch):
    """A program whose tick cannot take instances is refused before set-up."""
    from pbrt_bench import port
    mods = port.load()

    class Renderer:
        def tick(self, key=0):
            return None
    monkeypatch.setitem(mods, "render.renderer", types.SimpleNamespace(Renderer=Renderer))
    monkeypatch.setattr(port, "load", lambda: mods)
    ctx = Context(CELL, SEED, torch.device("cpu"))
    with pytest.raises(SystemExit, match="instances"):
        moving.Driver(ctx)


def test_layout_has_the_cell():
    bench = harness.benchmark()
    assert CELL in test_layout.CELLS
    w = next(x for x in bench["workloads"] if x["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("bench_spheres_game_270p", "bf16-moving", 1)
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")}
    assert e2e == {"frame_ms", "frame_ms_p95", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")}
    frame = {m["name"] for m in bench["per_layer"] if m["name"].endswith(".frame")}
    assert layer == frame
    for name in ("rebuild_host_ms.frame", "film_reset_pct.frame"):
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"
    cfg = scenes.load_json("configs", "bench_spheres_game_270p")
    bench_cfg = scenes.load_json("configs", "bench_spheres_720p")
    for k in ("models", "instances", "lights", "camera"):
        assert cfg[k] == bench_cfg[k], k
    assert (cfg["render"]["width"], cfg["render"]["height"]) == (480, 270)
    assert cfg["build"]["flatten"] is False


MS = 1_000_000


def _rec(name, parent, tick, start, end, **kw):
    return dict(dict(name=name, parent=parent, tick=tick, start_ns=start * MS, end_ns=end * MS,
                     reads=0, wait_ns=0, lanes=0, live=0, attrs={}), **kw)


def _run(recs, monkeypatch, iterations=2):
    from pbrt_bench.tests.test_spans import fake_run
    spans = harness.load_module("metrics", "spans")
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        types.SimpleNamespace(spans=lambda: [dict(r) for r in recs]))
    return fake_run("frame", iterations)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_readers(monkeypatch):
    recs = []
    for tick, (rebuild_ms, reset) in enumerate([(20, 30), (30, 50), (99, 99)]):
        base = len(recs)
        recs.append(_rec("pbrt.tick", -1, tick, 0, 200, slots=0, reset=0))
        recs.append(_rec("pbrt.rebuild", base, tick, 1, 1 + rebuild_ms, slots=0, reset=0))
        recs.append(_rec("pbrt.film", base, tick, 150, 190, slots=100, reset=reset))
    run = _run(recs, monkeypatch)
    assert _read("rebuild_host_ms.frame", run) == pytest.approx(25.0)
    assert _read("film_reset_pct.frame", run) == pytest.approx(40.0)


def test_readers_silent_on_a_program_without_them(monkeypatch):
    """The parent's records: no rebuild span, no reset keys."""
    recs = [_rec("pbrt.tick", -1, 0, 0, 200), _rec("pbrt.film", 0, 0, 150, 190)]
    run = _run(recs, monkeypatch)
    assert _read("rebuild_host_ms.frame", run) is None
    assert _read("film_reset_pct.frame", run) is None


@pytest.mark.cuda
def test_faults_caught_on_card(card):
    """At the cell's own size on the card, two seeds a fault; prints each
    reading as a JSON line (``pytest -s``)."""
    for fault in FAULTS:
        for seed in (SEED, SEED + 1):
            ctx = Context(CELL, seed, card)
            off, limit = _reading(ctx, fault, iterations=8)["pixels_off"]
            print(json.dumps({"cell": CELL, "seed": seed, "kind": fault, "pixels_off": off}),
                  flush=True)
            assert off > limit
            torch.cuda.empty_cache()
