"""The recorded frame chunk (``render/graph.py``) and the integrator body it
records, on the CPU with the plain engines: the bf16 engine's one retest,
the frame's seed table gives today's streams, a refreshed recording renders
the new scene as the eager path does and leaves the old scene as it was,
the rule that decides where a tick records, and the body's reads of the
host (none, also in the dead and all-miss chunks where the JAX package's
gates skip work; the body against the JAX package:
``tests/test_torch_render.py::test_one_body_matches_jax``). Where a GPU is
present (``cuda``-marked), the recording itself: replayed ticks against
eager ticks on the card, bit for bit, and the recorded train step
(``diff/inverse.py``'s ``StepGraph``) against eager steps, bit for bit.

No JAX here: the file runs on the card as
``python -m pytest --noconftest tests/test_torch_graph.py -m cuda``."""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig, RenderMode
from physically_based_ray_tracer_tpu_torch.diff import inverse as inverse_mod
from physically_based_ray_tracer_tpu_torch.diff.grad import adam, clone_params, trainable
from physically_based_ray_tracer_tpu_torch.ops import take_rows, trace, trace_bf16
from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
from physically_based_ray_tracer_tpu_torch.render import graph as graph_mod
from physically_based_ray_tracer_tpu_torch.render import integrator
from physically_based_ray_tracer_tpu_torch.render import renderer as renderer_mod
from physically_based_ray_tracer_tpu_torch.render.renderer import (Renderer, _chunks,
                                                                   _render_spp, render_chunked)
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera, primary_rays
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene, cornell_box
from physically_based_ray_tracer_tpu_torch.scene.procedural import make_quad, make_sphere
from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance, MeshModel,
                                                               build_scene_instanced,
                                                               rebuild_scene)
from physically_based_ray_tracer_tpu_torch.utils import profiling, rng
from torch_step import HostReads, bench_step_problem, unwatch_plain_engines

# one intra-op thread a test process, as tests/torch_port.py sets it: the
# suite runs several processes side by side
torch.set_num_threads(1)

CPU = torch.device("cpu")
KEY = 3_000_000_007
BASE_CFG = RenderConfig(width=16, height=9, bounces=4, antialias=True, skybox=False,
                        one_shadow_ray=True, chunk_pixels=64)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@functools.lru_cache(maxsize=None)
def _bench():
    scene, cam, _ = build_bench_scene(device=CPU)
    return scene, cam


@functools.lru_cache(maxsize=None)
def _cornell():
    return cornell_box(device=CPU)


@functools.lru_cache(maxsize=None)
def _floor():
    """One floor quad under a camera looking straight down at it, lit by a
    point light: every primary ray hits it, and every bounce ray leaves
    upward into nothing (all lanes dead after bounce 1)."""
    floor = MeshModel.from_fat(make_quad([-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4]),
                               base_color=(0.7, 0.7, 0.7), roughness=0.6)
    lights = LightSet.make(point_pos=[[0.5, 3.0, 0.2]], point_color=[[9.0, 9.0, 9.0]],
                           device=CPU)
    scene, _, _ = build_scene_instanced([floor], [Instance(0)], lights, legacy_bvh=False,
                                        flatten=True, device=CPU)
    cam = Camera.make(pos=(0.0, 3.0, 0.01), target=(0.0, 0.0, 0.0), device=CPU)
    return scene, cam


def _with_sky(scene):
    gen = torch.Generator().manual_seed(5)
    return dataclasses.replace(scene, sky=torch.rand((8, 16, 3), generator=gen))


def _rays(cam, cfg, ids):
    xs = torch.remainder(ids, cfg.width).to(torch.float32)
    ys = torch.div(ids, cfg.width, rounding_mode="floor").to(torch.float32)
    return primary_rays(cam, xs, ys, cfg.width, cfg.height)


@contextlib.contextmanager
def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` inside the block."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    with monkeypatch.context() as m:
        m.setattr(module, name, spy)
        yield calls


@pytest.mark.parametrize("need", [False, True], ids=["no_lane_needs_it", "some_lanes"])
def test_retest_runs_once(need, monkeypatch):
    """The bf16 engine's retest launches B1 exactly once, with no host read:
    where no lane needs it, it gives ``cert``; on the lanes that need it,
    B1's own verdict, and ``cert`` elsewhere."""
    scene, cam = _cornell()
    cfg = BASE_CFG.replace(width=8, height=8)
    ids = torch.arange(64, dtype=torch.int32)
    o, d = _rays(cam, cfg, ids)
    gen = torch.Generator().manual_seed(3)
    cert = torch.rand(64, generator=gen) < 0.3
    unc = cert.clone() if not need else cert | (torch.rand(64, generator=gen) < 0.4)
    t_max = torch.full((64,), 5.0)
    profiling.reset()
    with _spy(monkeypatch, trace, "intersect_any_dense") as retests:
        occ = trace_bf16._resolve_uncertain(scene.dense, o, d, t_max, cert, unc, True)
    assert len(retests) == 1 and profiling.READS == {}
    want = unc & ~cert
    assert bool(want.any()) == need
    exact = trace.intersect_any_dense(scene.dense, o, d, t_max)
    assert torch.equal(occ[want], exact[want]) and torch.equal(occ[~want], cert[~want])
    if not need:
        assert torch.equal(occ, cert)
    else:
        assert bool(exact[want].any()) and not bool(exact[want].all())


def test_seed_table_gives_todays_streams(monkeypatch):
    """The device seed table holds stream_seed for every (sample, bounce,
    purpose) a tick draws, the AA and uniform2 streams included, at the
    tick's sample offset; each uniform it gives, and the render, equal
    today's."""
    scene, cam = _cornell()
    cfg = BASE_CFG.replace(width=8, height=8, samples_per_pixel=2)
    ids = torch.arange(0, 64, 3, dtype=torch.int32)
    sample = 5
    drawn = set()
    real = rng.stream_seed

    def recorded(key, s, bounce, purpose):
        drawn.add((s, bounce, int(purpose)))
        return real(key, s, bounce, purpose)
    with monkeypatch.context() as m:
        m.setattr(rng, "stream_seed", recorded)
        c_eager, t_eager = _render_spp(scene, cam, cfg, KEY, sample, ids)
    table = rng.SeedTable(2 * cfg.bounces * 3 * len(rng.Purpose), CPU)
    _render_spp(scene, cam, cfg, table, 0, ids)      # names the streams
    base = sample * cfg.samples_per_pixel
    table.fill(KEY, base)
    assert {(base + s, b, p) for s, b, p in table.streams} == drawn
    assert any(p >= 101 for _, _, p in drawn) and any(b > 0 for _, b, _ in drawn)
    for (s, b, p), slot in table.streams.items():
        assert int(table.table[slot]) == rng.stream_seed(KEY, base + s, b, p)
        pid = torch.arange(0, 2 * cfg.n_pixels, 7)
        assert _same(rng.uniform1(table, pid, s, b, p), rng.uniform1(KEY, pid, base + s, b, p))
    c, t = _render_spp(scene, cam, cfg, table, 0, ids)
    assert _same(c, c_eager) and _same(t, t_eager)


def _world(n_lat=6):
    """Three small spheres over a floor, two-level (the layout a refresh
    keeps): (scene, handle, camera)."""
    sphere = MeshModel.from_fat(make_sphere(radius=0.5, lat=n_lat, lon=2 * n_lat),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4, metalness=0.2)
    floor = MeshModel.from_fat(make_quad([-4, -0.5, -4], [4, -0.5, -4], [4, -0.5, 4],
                                         [-4, -0.5, 4]), base_color=(0.6, 0.6, 0.6))
    lights = LightSet.make(point_pos=[[1, 3, 1], [-2, 2, 0]],
                           point_color=[[9, 9, 9], [4, 5, 6]], dir_pos=[[3, 6, 2]],
                           dir_color=[[1.0, 0.9, 0.8]], device=CPU)
    scene, handle, _ = build_scene_instanced([sphere, floor], _poses(0), lights,
                                             legacy_bvh=False, flatten=False, device=CPU)
    cam = Camera.make(pos=(0.0, 1.5, 4.0), target=(0.0, 0.0, 0.0), device=CPU)
    return scene, handle, cam


def _poses(k):
    return [Instance(0, position=(-1.2 + 0.05 * k, 0.02 * k, 0.0)),
            Instance(0, position=(0.0, 0.0, 0.3 - 0.04 * k), rotation=(0.0, 0.1 * k, 0.0)),
            Instance(0, position=(1.2, 0.03 * k, -0.5)), Instance(1)]


def _graph(scene, cam, cfg, ids):
    b = ids.shape[0]
    g = graph_mod.ChunkGraph(_render_spp, scene, cam, cfg, *_chunks(ids, cfg.chunk_pixels),
                             b, CPU)
    g.capture()
    return g


def test_refresh_renders_the_new_scene_and_keeps_the_old():
    """A recording made on scene A, refreshed with a moved scene B (the
    refresh copies the moved tensors only), renders B as the eager path
    does, bit for bit, and leaves A's tensors as they were; a change of
    shape or of configuration is not taken (the tick records anew)."""
    cfg = BASE_CFG.replace(chunk_pixels=48)
    scene_a, handle, cam = _world()
    ids = torch.from_numpy(renderer_mod.morton_pixel_order(cfg.width, cfg.height))
    g = _graph(scene_a, cam, cfg, ids)
    c_a, t_a = g.run(KEY, 0)
    assert g.n_chunks == 3
    assert _same(c_a, render_chunked(scene_a, cam, cfg, KEY, 0, ids)[0])
    kept = {k: v.clone() for k, v in graph_mod._leaves(scene_a)
            if isinstance(v, torch.Tensor)}
    scene_b = rebuild_scene(scene_a, handle, _poses(3), device=CPU)
    assert g.accepts(scene_b, cam, cfg)
    copied = g.refresh(scene_b, cam)
    assert 0 < copied < len(kept)
    assert g.refresh(scene_b, cam) == 0
    c_b, t_b = g.run(KEY, 1)
    e_c, e_t = render_chunked(scene_b, cam, cfg, KEY, 1, ids)
    assert _same(c_b, e_c) and _same(t_b, e_t)
    assert not _same(t_b, t_a)
    assert all(torch.equal(v, dict(graph_mod._leaves(scene_a))[k]) for k, v in kept.items())
    assert not g.accepts(_world(n_lat=5)[0], cam, cfg)
    assert not g.accepts(scene_b, cam, cfg.replace(bounces=3))
    moved_cam = Camera.make(pos=(0.2, 1.5, 4.0), target=(0.0, 0.0, 0.0), device=CPU)
    assert g.accepts(scene_b, moved_cam, cfg)
    assert g.refresh(scene_b, moved_cam) == len(graph_mod._tensors(moved_cam))


def _tick_attrs(r, *args, activities=(torch.profiler.ProfilerActivity.CPU,), **kwargs):
    """A tick under the profiler (spans on); the tick span's attributes and
    the image."""
    profiling.reset()
    with torch.profiler.profile(activities=list(activities)):
        img = r.tick(*args, **kwargs)
    ticks = [s for s in profiling.spans() if s["name"] == "pbrt.tick"]
    return ticks[-1]["attrs"], img


def test_renderer_takes_the_recorded_path_where_the_rule_allows(monkeypatch):
    """With the rule let through on the CPU, Renderer.tick runs the recorded
    body (run as it is: no CUDA graph here) over three moving ticks and
    gives the eager ticks' films and images bit for bit; the tick span
    counts one capture, then refreshes."""
    cfg = BASE_CFG.replace(chunk_pixels=48)
    scene, handle, cam = _world()
    eager = Renderer(scene, cam, cfg, device=CPU, handle=handle)
    eager_out = []
    for k in (1, 2, 3):
        attrs, img = _tick_attrs(eager, KEY, instances=_poses(k))
        assert {k: attrs[k] for k in ("chunks", "replays", "captures", "refreshed")} == {
            "chunks": 3, "replays": 0, "captures": 0, "refreshed": 0}
        eager_out.append((img, eager.film))
    scene, handle, cam = _world()
    monkeypatch.setattr(renderer_mod, "graph_path", lambda cfg, device: True)
    r = Renderer(scene, cam, cfg, device=CPU, handle=handle)
    for k, (img_e, film_e) in zip((1, 2, 3), eager_out):
        attrs, img = _tick_attrs(r, KEY, instances=_poses(k))
        assert attrs["captures"] == (1 if k == 1 else 0) and attrs["chunks"] == 3
        assert attrs["replays"] == 0 and (k == 1 or attrs["refreshed"] > 0)
        assert np.array_equal(img, img_e)
        assert all(_same(a, b) for a, b in zip(r.film, film_e))
    r.config = cfg.replace(bounces=2)
    attrs, _ = _tick_attrs(r, KEY)
    assert attrs["captures"] == 1


@pytest.mark.parametrize("change", [
    {}, {"rendering_mode": RenderMode.DEPTH}, {"traversal": "pallas_rows"},
    {"traversal": "wave"}, {"traversal": "packet"}, {"traversal": "lane"},
    {"shade_tile": 64}, {"reshard_axis": "x", "reshard_ndev": 2}],
    ids=["brdf_pallas", "aov", "rows", "wave", "packet", "lane", "shade_tile", "mesh"])
def test_engagement_rule(change):
    """The recorded path is taken on the card, for the shaded image on the
    dense engines alone, with no shade tiles and no mesh; never on the CPU."""
    cfg = BASE_CFG.replace(**change)
    assert graph_mod.graph_path(cfg, torch.device("cuda", 0)) == (not change)
    assert not graph_mod.graph_path(cfg, CPU)


# (scene, camera, config changes, the chunk's pixel ids)
BODY_CASES = {
    "bench_bf16": (_bench, {}, (40, 64)),
    "bench_f32": (_bench, {"leaf_precision": "f32"}, (40, 64)),
    # the area light, two in-frame samples
    "cornell_spp2": (_cornell, {"width": 8, "height": 8, "samples_per_pixel": 2}, (40, 64)),
    # the sky, the Panini projection, every point light's shadow ray
    "bench_sky_panini": (lambda: (_with_sky(_bench()[0]), _bench()[1]),
                         {"skybox": True, "post_processed": True, "one_shadow_ray": False},
                         (40, 64)),
    # every lane dead after bounce 1, and every lane a miss at bounce 0: the
    # chunks where the JAX package's gates skip work
    "dead_after_bounce1": (_floor, {"width": 8, "height": 8}, (40, 64)),
    "all_miss": (_bench, {}, (0, 16)),
}


@pytest.mark.parametrize("case", BODY_CASES)
def test_body_reads_nothing_on_the_host(case, monkeypatch):
    """After one pass, the body (one chunk) makes no host read and no
    upload outside the engines' plain versions, which the card replaces by
    its kernels, and runs every bounce's closest-hit pass."""
    make, changes, (lo, hi) = BODY_CASES[case]
    scene, cam = make()
    cfg = BASE_CFG.replace(**changes)
    ids = torch.arange(lo, hi, dtype=torch.int32)
    table = rng.SeedTable(2 * cfg.bounces * 3 * len(rng.Purpose), CPU)
    _render_spp(scene, cam, cfg, table, 0, ids)
    mode = HostReads()
    unwatch_plain_engines(monkeypatch)
    profiling.reset()
    with mode, _spy(monkeypatch, integrator, "_closest") as passes:
        _render_spp(scene, cam, cfg, table, 0, ids)
    assert mode.seen == [] and mode.ops > 1000 and profiling.READS == {}
    assert len(passes) == cfg.bounces * max(1, cfg.samples_per_pixel)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _films_equal(a, b) -> bool:
    return all(_same(x, y) for x, y in zip(a, b))


def _eager_ticks(monkeypatch, make, cfg, dev, n, moving):
    """``n`` eager ticks of a fresh renderer (the rule refused): films and
    images."""
    scene, cam, handle = make(dev)
    out = []
    with monkeypatch.context() as m:
        m.setattr(renderer_mod, "graph_path", lambda cfg, device: False)
        r = Renderer(scene, cam, cfg, device=dev, handle=handle)
        for k in range(1, n + 1):
            img = r.tick(KEY, instances=_bench_poses(k) if moving else None)
            out.append((img, r.film))
    return out


def _bench_poses(k):
    return [Instance(0, position=(dx + 0.04 * k, 0.02 * k, dz))
            for dx in (-2.2, 0.0, 2.2) for dz in (-2.2, 0.0, 2.2)] + [Instance(1)]


def _bench_on(dev):
    scene, cam, _, handle = build_bench_scene(flatten=False, return_handle=True, device=dev)
    return scene, cam, handle


@pytest.mark.cuda
@pytest.mark.parametrize("moving", [False, True], ids=["bench_720p", "game_270p_moving"])
def test_replay_equals_eager_on_card(card, moving, monkeypatch):
    """Capture and replay over three ticks give the eager ticks' films and
    images bit for bit (the bench frame; the game's 480x270 tick with all
    nine spheres moving); a fourth, replayed under the profiler, too, and
    the tick span counts its replays."""
    cfg = RenderConfig(width=480 if moving else 1280, height=270 if moving else 720,
                       bounces=4, antialias=True, one_shadow_ray=True, skybox=False)
    eager = _eager_ticks(monkeypatch, _bench_on, cfg, card, 4, moving)
    scene, cam, handle = _bench_on(card)
    r = Renderer(scene, cam, cfg, device=card, handle=handle)
    n_chunks = _chunks(r._pixel_ids, cfg.chunk_pixels)[1]
    for k, (img_e, film_e) in enumerate(eager, start=1):
        launches = dict(trace_bf16.LAUNCHES)
        poses = _bench_poses(k) if moving else None
        if k < 4:
            img = r.tick(KEY, instances=poses)
        else:
            attrs, img = _tick_attrs(r, KEY, instances=poses,
                                     activities=[torch.profiler.ProfilerActivity.CPU,
                                                 torch.profiler.ProfilerActivity.CUDA])
            assert {k: attrs[k] for k in ("chunks", "replays", "captures")} == {
                "chunks": n_chunks, "replays": n_chunks, "captures": 0}
            assert (attrs["refreshed"] > 0) == moving
        assert np.array_equal(img, img_e) and _films_equal(r.film, film_e), k
        assert r._graph is not None and r._graph.graph is not None
        # the first tick's warm-up pass runs the chunk once more, as it is
        warm = cfg.bounces if k == 1 else 0
        assert trace_bf16.LAUNCHES["closest"] - launches["closest"] == (
            n_chunks * cfg.bounces + warm)


# the recorded train step on the card: the inverse cell's problem at a
# quarter of its width and height, a quarter of its batch, its learning rate
STEP_SIZE = (320, 180)
STEP_BATCH = 16384
STEP_LR = 0.02


def _step_attrs(step, *args, traced):
    """One train step, under the profiler (spans on, the card traced too)
    where ``traced``; the step span's attributes (None untraced) and the
    loss."""
    if not traced:
        return None, step(*args)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        loss = step(*args)
    return [s for s in profiling.spans() if s["name"] == "pbrt.step"][-1]["attrs"], loss


def _span_names() -> set:
    return {s["name"] for s in profiling.spans()}


def _train(card, problem, n, monkeypatch, eager):
    """``n`` steps of the problem from its start, a batch drawn per step;
    the last one traced. Per step: the loss, each leaf, its gradient and
    Adam's moments after it, the row gather's launches and the step span's
    attributes. Then the step function, parameters and batch."""
    scene, cam, cfg, target, start = problem
    params = clone_params(start)
    opt = adam(params, STEP_LR)
    gen = torch.Generator(device=card)
    gen.manual_seed(KEY)
    out = []
    with monkeypatch.context() as m:
        if eager:
            m.setattr(inverse_mod, "graph_path", lambda cfg, device: False)
        step = inverse_mod.make_train_step(scene, cam, cfg, opt)
        for k in range(n):
            ids = torch.randperm(cfg.n_pixels, generator=gen,
                                 device=card)[:STEP_BATCH].to(torch.int32)
            launches = take_rows.LAUNCHES
            attrs, loss = _step_attrs(step, params, KEY, k, ids, target[ids.long()],
                                      traced=k == n - 1)
            leaves = trainable(params)
            out.append(dict(
                loss=loss, leaves=[v.detach().clone() for v in leaves],
                grads=[v.grad.clone() for v in leaves],
                moments=[opt.state[v][m].clone() for v in leaves
                         for m in ("exp_avg", "exp_avg_sq")],
                launches=take_rows.LAUNCHES - launches, attrs=attrs))
    return out, step, params, ids


@pytest.mark.cuda
def test_recorded_step_equals_eager_on_card(card, monkeypatch):
    """Over 4 steps of the bench problem, the warm-up step, the step that
    records and replays, and two replays give the eager steps' losses,
    leaves, gradients and Adam moments bit for bit, with 9 row-gather
    launches a step either way; the traced replay's step span counts one
    replay. A step with another batch size, another parameter dict or a
    mesh runs eagerly, and the recording replays again after it."""
    problem = bench_step_problem(card, *STEP_SIZE)
    eager, _, _, _ = _train(card, problem, 4, monkeypatch, eager=True)
    replayed, step, params, ids = _train(card, problem, 4, monkeypatch, eager=False)
    for k, (e, r) in enumerate(zip(eager, replayed)):
        assert _same(e["loss"], r["loss"]), k
        for key in ("leaves", "grads", "moments"):
            assert all(_same(a, b) for a, b in zip(e[key], r[key])), (k, key)
        assert e["launches"] == r["launches"] == 9, k
    assert eager[-1]["attrs"] == {"replays": 0, "captures": 0}
    assert replayed[-1]["attrs"] == {"replays": 1, "captures": 0}
    assert not _span_names() & {"pbrt.forward", "pbrt.backward"}

    scene, cam, cfg, target, start = problem
    short = ids[:STEP_BATCH // 2]
    for args in ((params, KEY, 4, short, target[short.long()]),
                 (clone_params(start), KEY, 4, ids, target[ids.long()])):
        attrs, _ = _step_attrs(step, *args, traced=True)
        assert attrs == {"replays": 0, "captures": 0} and "pbrt.forward" in _span_names()
    attrs, _ = _step_attrs(step, params, KEY, 5, ids, target[ids.long()], traced=True)
    assert attrs == {"replays": 1, "captures": 0}
    assert all(v.grad is not None for v in trainable(params))
    mesh = make_mesh(1, device=card)
    try:
        p = clone_params(start)
        sharded = inverse_mod.make_sharded_train_step(mesh, scene, cam, cfg, adam(p, STEP_LR))
        for k in range(2):
            attrs, _ = _step_attrs(sharded, p, KEY, k, ids, target[ids.long()], traced=True)
            assert attrs == {"replays": 0, "captures": 0}, k
    finally:
        mesh.close()
