"""Instances moved inside ``Renderer.tick`` (the game loop's tick: pose sync,
TLAS refresh, render into the depth-keyed film) against the benchmark's
plain reference, which bakes each tick's poses from scratch.

A tiny scene on the CPU: two UV spheres (lat 8, lon 16) and the floor,
48 x 27, 4 bounces, seeded closed-form motion (``pbrt_bench``'s
``Motion``). No JAX."""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import pytest
import torch

from pbrt_bench import port, scenes
from pbrt_bench.drivers import moving
from pbrt_bench.reference import integrator
from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.ops import trace
from physically_based_ray_tracer_tpu_torch.render import film as film_mod
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer, render_chunked
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays
from physically_based_ray_tracer_tpu_torch.scene.scene import rebuild_scene
from physically_based_ray_tracer_tpu_torch.utils import profiling
from physically_based_ray_tracer_tpu_torch.utils.profiling import annotate, host_read
from physically_based_ray_tracer_tpu_torch.utils.timer import DeviceTimer, ray_count

SEED = 3_000_000_019
CPU = torch.device("cpu")
RENDER = {"width": 48, "height": 27, "bounces": 4, "antialias": True,
          "one_shadow_ray": True, "skybox": False, "chunk_pixels": 65536}
BUILD = {"flatten": False, "dense_leaf_target": 16}
MOTION = {"model": 0, "ticks_per_s": 30, "bound": 4.0, "speed": [1.0, 3.0],
          "apex": [0.5, 2.0], "gravity": 9.81, "spin": [0.5, 2.0]}
TICKS = 5
BF16_LIMIT = 0.1        # the bench bf16 cells' pixels_off limit
SPHERE_TRIS = 2 * 8 * 16
SHADING = ("tri_v0", "tri_e1", "tri_e2", "face_normal", "corner_normal")


def _inputs():
    cfg = scenes.load_json("configs", "bench_spheres_game_270p")
    sphere = dict(cfg["models"][0], mesh=dict(cfg["models"][0]["mesh"], lat=8, lon=16))
    return scenes.scene_inputs(dict(cfg, models=[sphere, cfg["models"][1]],
                                    instances=[{"model": 0, "position": [-1.2, 0, 0]},
                                               {"model": 0, "position": [1.2, 0, 1.0]},
                                               {"model": 1}]))


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return port.load(), inputs, moving.Motion(inputs["instances"], MOTION, SEED)


def _renderer(world, precision="f32", handle=True):
    mods, inputs, motion = world
    scene, h, cam = moving.build_scene(mods, inputs, motion.poses(0), BUILD, CPU)
    cfg = RenderConfig(**RENDER, leaf_precision=precision)
    return Renderer(scene, cam, cfg, device=CPU, handle=h if handle else None)


def _poses(world, k):
    mods, _, motion = world
    return moving.port_instances(mods, motion.poses(k))


def _run_ticks(world, r, ticks):
    out = []
    for k in range(1, ticks + 1):
        before, sample = r.film, r.sample
        img = r.tick(SEED, instances=_poses(world, k))
        out.append((k, sample, before, r.film, img))
    return out


@contextlib.contextmanager
def _spans():
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


@pytest.mark.parametrize("precision,limit", [("f32", 0.0), ("bf16", BF16_LIMIT)])
def test_moving_ticks_match_reference(world, precision, limit):
    """Each of 5 moving ticks' film and image against the reference's
    from-scratch bake of that tick's poses, every slot checked."""
    _, inputs, motion = world
    r = _renderer(world, precision)
    ticks = _run_ticks(world, r, TICKS)
    n = RENDER["width"] * RENDER["height"]
    off, total = moving.compare_ticks(inputs, RENDER, SEED, motion, ticks, n, CPU)
    assert total == TICKS * n
    assert off / total <= limit, (off, total)


def test_refreshed_hits_equal_fresh_build(world):
    """The refreshed two-level table's closest hits equal a fresh build's at
    the same poses (the camera's rays and seeded rays from inside the
    scene)."""
    mods, inputs, motion = world
    r = _renderer(world)
    _run_ticks(world, r, 3)
    fresh, _, _ = moving.build_scene(mods, inputs, motion.poses(3), BUILD, CPU)
    assert not torch.equal(r.scene.dense.inst16, _renderer(world).scene.dense.inst16)
    w, h = RENDER["width"], RENDER["height"]
    ids = torch.arange(w * h)
    o, d = primary_rays(r.camera, (ids % w).float(), (ids // w).float(), w, h)
    g = torch.Generator().manual_seed(5)
    o2 = (torch.rand((512, 3), generator=g) - 0.5) * torch.tensor([8.0, 4.0, 8.0])
    d2 = torch.nn.functional.normalize(torch.randn((512, 3), generator=g), dim=1)
    o, d = torch.cat([o, o2]), torch.cat([d, d2])
    got = trace.intersect_closest_dense(r.scene.dense, o, d)
    want = trace.intersect_closest_dense(fresh.dense, o, d)
    assert (got.prim >= 0).sum() > 0.5 * o.shape[0]
    assert torch.equal(got.prim, want.prim)
    assert torch.equal(got.t, want.t)
    for k in SHADING:
        assert torch.equal(getattr(r.scene, k), getattr(fresh, k)), k


def test_rebuild_span_only_with_instances(world):
    r = _renderer(world)
    with _spans():
        r.tick(SEED, instances=_poses(world, 1))
        r.tick(SEED)
    recs = profiling.spans()
    ticks = [i for i, x in enumerate(recs) if x["name"] == "pbrt.tick"]
    rebuilds = [x for x in recs if x["name"] == "pbrt.rebuild"]
    assert len(ticks) == 2 and len(rebuilds) == 1
    rb = rebuilds[0]
    assert rb["parent"] == ticks[0] and rb["tick"] == recs[ticks[0]]["tick"]
    assert rb["attrs"] == {"moved": 2, "tris": 2 * SPHERE_TRIS}
    assert rb["end_ns"] <= min(x["start_ns"] for x in recs
                               if x["name"] == "pbrt.closest" and x["tick"] == rb["tick"])


def test_reset_counter_counts_restarted_slots(world):
    """On a non-empty film, a slot restarted exactly where its spp is 1
    after the tick; the count sits on the tick's ``pbrt.film`` span and
    every record carries the keys."""
    r = _renderer(world)
    _run_ticks(world, r, 1)
    with _spans():
        r.tick(SEED, instances=_poses(world, 2))
    recs = profiling.spans()
    assert all("reset" in x and "slots" in x for x in recs)
    film = [x for x in recs if x["name"] == "pbrt.film"]
    assert len(film) == 1
    restarted = int((r.film.spp == 1).sum())
    assert 0 < restarted < r.config.n_pixels
    assert (film[0]["reset"], film[0]["slots"]) == (restarted, r.config.n_pixels)
    assert sum(x["reset"] for x in recs) == restarted


def _tick_without_motion(r, key):
    """``Renderer.tick`` as it was before instances could move inside it."""
    with annotate("pbrt.tick"), contextlib.ExitStack() as timed:
        timer = timed.enter_context(DeviceTimer(r.device))
        color, primary_t = render_chunked(r.scene, r.camera, r.config, key, r.sample,
                                          r._pixel_ids)
        with annotate("pbrt.film"):
            r.film, avg = film_mod.update(r.film, color, primary_t, r.config)
            avg = host_read("film_fetch", avg)
            timed.close()
            r.sample += 1
            r.stats.update(timer.ms, ray_count(r.config, r.config.n_pixels,
                                               n_point_lights=r.scene.lights.n_point))
            return r._assemble(avg)


def _op_counts(prof) -> collections.Counter:
    return collections.Counter({e.key: e.count for e in prof.key_averages()})


def test_tick_without_instances_runs_what_it_ran(world):
    """``tick(key)`` on a renderer that holds a handle runs the operations
    the tick ran before it could move instances, counted by the profiler,
    and gives the same film and image."""
    new, old = _renderer(world), _renderer(world)
    with _spans() as p_new:
        img_new = new.tick(SEED)
    with _spans() as p_old:
        img_old = _tick_without_motion(old, SEED)
    assert _op_counts(p_new) == _op_counts(p_old)
    assert np.array_equal(img_new, img_old)
    assert torch.equal(new.film.accum, old.film.accum)


def test_instances_without_handle_refused(world):
    r = _renderer(world, handle=False)
    before = r.film
    with pytest.raises(ValueError, match="handle"):
        r.tick(SEED, instances=_poses(world, 1))
    assert r.film is before and r.sample == 0


def test_reference_counts_queries(world):
    """The check's reference counts its live queries on the moving scene
    (the traversal roofline's work), once per checked slot."""
    _, inputs, motion = world
    r = _renderer(world)
    ticks = _run_ticks(world, r, 2)
    counts = integrator.QueryCount()
    moving.compare_ticks(inputs, RENDER, SEED, motion, ticks, 256, CPU, counts)
    assert counts.closest >= 2 * 256


@pytest.mark.cuda
def test_rebake_on_card_matches_host(world):
    """On the card, three refreshes bake the moved instances there; the
    shading arrays agree with the host's from-scratch bake of the last
    poses within f32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    mods, inputs, motion = world
    dev = torch.device("cuda")
    scene, handle, _ = moving.build_scene(mods, inputs, motion.poses(0), BUILD, dev)
    for k in (1, 2, 3):
        scene = rebuild_scene(scene, handle, _poses(world, k), device=dev)
    fresh, _, _ = moving.build_scene(mods, inputs, motion.poses(3), BUILD, CPU)
    for k in SHADING:
        torch.testing.assert_close(getattr(scene, k).cpu(), getattr(fresh, k),
                                   rtol=1e-6, atol=1e-6, msg=k)
