"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Off (no profiler recording), a tick records nothing and ``annotate`` hands
out its shared no-op. Under ``torch.profiler`` (host ops only), a tick
records one tree: ``pbrt.tick`` > ``pbrt.closest`` / ``pbrt.shade`` (each
with its bounce's ``depth``; ``pbrt.occlusion`` inside the shading) and
``pbrt.film``, none of them a profiler event of its own. ``trace``'s export
puts a span around the profiler's own events of its block. The host-read
counter meets the profiler's count of scalar reads plus the film's fetch;
the live-lane counter of the closest-hit launches meets the lanes alive at
each bounce, counted from the debug records; a train step records
``pbrt.step`` > ``pbrt.forward``, ``pbrt.backward``."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import adam, clone_params
from physically_based_ray_tracer_tpu_torch.diff.inverse import make_train_step
from physically_based_ray_tracer_tpu_torch.render import integrator
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays
from physically_based_ray_tracer_tpu_torch.scene.presets import sphere_demo
from physically_based_ray_tracer_tpu_torch.utils import profiling

# two chunks of 96 pixels, AA (192 lanes a chunk), three bounces, one shadow ray
CFG = RenderConfig(width=16, height=12, bounces=3, antialias=True, skybox=False,
                   one_shadow_ray=True, chunk_pixels=96, max_stack_depth=24)
FRAME = ("pbrt.closest", "pbrt.shade", "pbrt.film")


@pytest.fixture(scope="module")
def demo():
    return sphere_demo(device="cpu")


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _traced_tick(scene, cam, cfg):
    r = Renderer(scene, cam, cfg, device="cpu")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.tick(5)
    return profiling.spans(), prof


def test_off_records_nothing(demo):
    assert not torch.autograd._profiler_enabled()
    r = Renderer(*demo, CFG.replace(leaf_precision="f32"), device="cpu")
    r.tick(0)
    assert profiling.spans() == []
    assert profiling.annotate("pbrt.tick") is profiling.annotate("pbrt.tick")
    assert profiling.annotate("pbrt.closest", depth=2) is profiling.annotate("pbrt.closest")
    assert profiling.READS["film_fetch"] == 1          # counted with tracing off too


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_tick_records_one_tree(demo, precision):
    recs, prof = _traced_tick(*demo, CFG.replace(leaf_precision=precision))
    names = [r["name"] for r in recs]
    assert names[0] == "pbrt.tick" and recs[0]["parent"] == -1
    assert {r["tick"] for r in recs} == {recs[0]["tick"]}
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    for r in recs[1:]:
        parent = recs[r["parent"]]
        assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
        if r["name"] in FRAME:
            assert parent["name"] == "pbrt.tick"
        else:
            assert (r["name"], parent["name"]) == ("pbrt.occlusion", "pbrt.shade")
    depths = [r["attrs"]["depth"] for r in recs if r["name"] == "pbrt.closest"]
    assert depths[:CFG.bounces] == list(range(CFG.bounces))
    assert [r["attrs"]["depth"] for r in recs if r["name"] == "pbrt.shade"] == depths
    assert names.count("pbrt.film") == 1 and names[-1] == "pbrt.film"
    assert 0 < names.count("pbrt.occlusion") <= names.count("pbrt.shade")
    occl = [r for r in recs if r["name"] == "pbrt.occlusion"]
    assert all(r["lanes"] > 0 for r in occl)
    if precision == "bf16":
        # one retest gate per occlusion pass of the bf16 engine
        assert profiling.READS["retest"] == len(occl)
    # the frame path makes no profiler event of its own
    assert not [e.name for e in prof.events() if e.name.startswith("pbrt.")]


def test_reads_match_the_profilers_scalar_reads(demo):
    """Every host read on the exact engine's frame path is one of the
    program's reads: the profiler's scalar reads plus the film's fetch."""
    recs, prof = _traced_tick(*demo, CFG.replace(leaf_precision="f32"))
    scalar = sum(e.name == "aten::_local_scalar_dense" for e in prof.events())
    reads = sum(r["reads"] for r in recs)
    assert reads == scalar + 1
    assert reads == sum(profiling.READS.values())
    film = next(r for r in recs if r["name"] == "pbrt.film")
    assert film["reads"] == 1 and film["wait_ns"] >= 0
    assert profiling.READS["film_fetch"] == 1
    assert profiling.READS["bounce_gate"] >= 2       # every chunk's first bounce


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_live_lanes_of_the_closest_launches(demo, precision):
    """The closest launches' live lanes are the lanes alive at each bounce
    (the debug records' ``alive_out``), with or without the gates."""
    scene, cam = demo
    cfg = CFG.replace(leaf_precision=precision)
    ids = torch.arange(96, dtype=torch.int32)
    o, d = primary_rays(cam, (ids % cfg.width).float(), (ids // cfg.width).float(),
                        cfg.width, cfg.height)
    counted = {}
    for debug in (True, False):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.annotate("pbrt.tick"):
                out = integrator.trace_paths(scene, cfg, o, d, ids, 3, 0, collect_debug=debug)
        closest = [r for r in profiling.spans() if r["name"] == "pbrt.closest"]
        counted[debug] = sum(r["live"] for r in closest)
        if debug:
            alive = out[2]["alive_out"]
            want = 96 + int(alive[:-1].sum())
            assert [r["lanes"] for r in closest] == [96] * cfg.bounces
    assert counted[True] == counted[False] == want
    assert 96 < want < 96 * cfg.bounces


def test_trace_encloses_the_profilers_events(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.annotate("pbrt.probe"):
            torch.ones(1 << 16).cumsum(0)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == "pbrt.probe")
    op = next(e for e in events if e.get("name") == "aten::cumsum")
    assert span["ts"] - 100 <= op["ts"]
    assert op["ts"] + op["dur"] <= span["ts"] + span["dur"] + 100


def test_decorator_decides_at_each_call():
    @profiling.annotate("pbrt.probe")
    def f(x):
        return x + 1
    assert f(1) == 2 and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        f(1)
    assert [r["name"] for r in profiling.spans()] == ["pbrt.probe"]


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("a"):
            with profiling.annotate("b"):
                with profiling.annotate("c"):
                    profiling.count_lanes(torch.tensor([1.0, 0.0]))
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["a", "b"] and profiling.dropped() == 1
    assert (recs[1]["lanes"], recs[1]["live"]) == (2, 1)   # the innermost recorded


def test_train_step_records_step_forward_backward(demo):
    scene, cam = demo
    cfg = CFG.replace(leaf_precision="f32")
    params = clone_params({"base_color": scene.mat_base,
                           "point_color": scene.lights.point_color})
    step = make_train_step(scene, cam, cfg, adam(params, 0.01))
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    target = torch.full((cfg.n_pixels, 3), 0.5)
    with profile(activities=[ProfilerActivity.CPU]):
        loss = step(params, 0, 0, ids, target)
    assert loss.ndim == 0
    recs = profiling.spans()
    assert recs[0]["name"] == "pbrt.step" and recs[0]["parent"] == -1
    kids = [r["name"] for r in recs if r["parent"] == 0]
    assert kids == ["pbrt.forward", "pbrt.backward"]
    fwd = next(i for i, r in enumerate(recs) if r["name"] == "pbrt.forward")
    assert {recs[r["parent"]]["name"] for r in recs if r["name"] == "pbrt.closest"} \
        == {"pbrt.forward"}
    assert any(r["parent"] == fwd for r in recs)
