"""Scenes of many meshes on the port's two-level path, on the CPU: BLAS
builds in worker processes give the serial build's tables byte for byte;
the build refuses a table whose float32 node codes would not be exact; a
small SPD sphereflake renders through ``build_scene_instanced(flatten=False)``
and ``Renderer.tick`` as the benchmark's reference does; the ``pbrt.build``
span and the tick's ``table_bytes`` count the tables. No JAX here."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrt_bench import port, scenes
from pbrt_bench.drivers import frames
from pbrt_bench.reference import geometry
from pbrt_bench.tests import test_spd_balls as spd
from physically_based_ray_tracer_tpu_torch.bvh import dense
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
from physically_based_ray_tracer_tpu_torch.scene import scene as sc
from physically_based_ray_tracer_tpu_torch.scene.procedural import make_sphere
from physically_based_ray_tracer_tpu_torch.utils import profiling

TABLES = ("nodes16", "groups", "inst16", "prim_base", "world_lo", "world_hi", "glo",
          "pids_c", "leaf_rec", "groups_bf2")
SEED = 3_000_000_007


def _meshes(n=24):
    """``n`` small meshes of mixed sizes (spheres of 8 to 192 triangles, a
    lone triangle), each placed apart, and their instances (the first four
    meshes twice)."""
    rng = np.random.default_rng(7)
    out = []
    for k in range(n):
        if k == 5:
            out.append(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32) + k)
            continue
        lat, lon = int(rng.integers(2, 9)), int(rng.integers(3, 13))
        tri = make_sphere(radius=0.2 + rng.random(), lat=lat, lon=lon)[0].reshape(-1, 3, 3)
        out.append((tri + rng.normal(size=3) * 4).astype(np.float32))
    inst_mesh = list(range(n)) + [0, 1, 2, 3]
    tf = np.tile(np.eye(4, dtype=np.float32), (len(inst_mesh), 1, 1))
    tf[n:, :3, 3] = [[9, 0, 0], [0, 9, 0], [0, 0, 9], [9, 9, 9]]
    return out, inst_mesh, tf


def _same(a, b, what):
    a, b = a.cpu(), b.cpu()
    assert (a.dtype, a.shape) == (b.dtype, b.shape), what
    assert a.contiguous().view(torch.uint8).equal(b.contiguous().view(torch.uint8)), what


def test_workers_build_the_serial_tables(monkeypatch):
    """Two spawned workers, 24 meshes: every table, the stack need, the
    TLAS head's constants and the depth as the serial build gives them."""
    meshes, inst_mesh, tf = _meshes()
    serial, smeta, sdepth = dense.build_dense_tlas(meshes, inst_mesh, tf, leaf_target=16,
                                                   shape=True)
    spawned = []
    real = dense._build_blases

    def spy(*args):
        spawned.append(args[-1])
        return real(*args)
    monkeypatch.setattr(dense, "_build_blases", spy)
    par, pmeta, pdepth = dense.build_dense_tlas(meshes, inst_mesh, tf, leaf_target=16,
                                                shape=True, workers=2)
    assert spawned == [2]
    for f in TABLES:
        _same(getattr(par, f), getattr(serial, f), f)
    _same(par.groups_bf.view(torch.int16), serial.groups_bf.view(torch.int16), "groups_bf")
    assert par.stack_need == serial.stack_need and pdepth == sdepth
    assert pmeta.tlas_cap == smeta.tlas_cap
    for f in ("inst_mesh", "blas_root", "blas_lo", "blas_hi", "blas_need"):
        a, b = getattr(pmeta, f), getattr(smeta, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # the BLAS stack needs counted in the workers equal the merged table's walk
    nodes = serial.nodes16.numpy().reshape(-1, dense.NODE_F)
    assert list(pmeta.blas_need) == [dense._walk_need(nodes, int(r)) for r in smeta.blas_root]


def test_workers_only_for_large_tables(monkeypatch):
    """The bench scene's two meshes build here; thousands of meshes use the
    cores this process may run on, and one core builds here too."""
    monkeypatch.setattr(dense.os, "sched_getaffinity", lambda pid: set(range(8)))
    tri = np.zeros((576, 3, 3), np.float32)
    assert dense._blas_workers([tri, tri[:2]]) == 0
    assert dense._blas_workers([tri] * 63 + [tri[:2]] * 1) == 0
    assert dense._blas_workers([tri[:2]] * 7382) == 0          # too few triangles
    assert dense._blas_workers([tri] * 7382) == 8
    monkeypatch.setattr(dense.os, "sched_getaffinity", lambda pid: {0})
    assert dense._blas_workers([tri] * 7382) == 0


@pytest.mark.parametrize("workers,used", [("auto", 5), (0, 0), (3, 3), ("many", None),
                                          (-1, None)])
def test_workers_option(workers, used, monkeypatch):
    """``workers`` "auto" takes ``_blas_workers``'s count, a count is used as
    given, anything else is refused; ``build_scene_instanced`` passes its
    ``blas_workers`` on."""
    monkeypatch.setattr(dense, "_blas_workers", lambda mesh_tris: 5)
    seen = []
    real = dense._build_blases

    def spy(*args):
        seen.append(args[-1])
        return real(*args[:-1], 0)
    monkeypatch.setattr(dense, "_build_blases", spy)
    meshes, inst_mesh, tf = _meshes(4)
    if used is None:
        with pytest.raises(ValueError, match="workers must be a count"):
            dense.build_dense_tlas(meshes, inst_mesh, tf, workers=workers)
        return
    dense.build_dense_tlas(meshes, inst_mesh, tf, workers=workers)
    models = [sc.MeshModel.from_fat(make_sphere((2.0 * k, 0, 0), 0.5, lat=3, lon=4))
              for k in range(2)]
    sc.build_scene_instanced(models, [sc.Instance(0), sc.Instance(1)], legacy_bvh=False,
                             blas_workers=workers, device="cpu")
    assert seen == [used, used]


@pytest.mark.parametrize("groups,nodes,refused", [
    (dense.MAX_GROUPS, dense.MAX_NODES, None),
    (dense.MAX_GROUPS + 1, 10, "leaf groups"),
    (10, dense.MAX_NODES + 1, "nodes"),
])
def test_code_guard_at_its_limits(groups, nodes, refused):
    if refused is None:
        dense._check_codes(nodes, groups)
        return
    with pytest.raises(ValueError, match=f"{max(groups, nodes)} {refused}"):
        dense._check_codes(nodes, groups)


@pytest.mark.parametrize("two_level", [False, True])
def test_builds_refuse_inexact_codes(two_level, monkeypatch):
    """With the limit stubbed to 3 groups, both builds name the count and
    raise before packing a table."""
    monkeypatch.setattr(dense, "MAX_GROUPS", 3)
    meshes, inst_mesh, tf = _meshes(6)
    with pytest.raises(ValueError, match=r"dense BVH of \d+ leaf groups"):
        if two_level:
            dense.build_dense_tlas(meshes, inst_mesh, tf, leaf_target=16, shape=True)
        else:
            dense.build_dense(np.concatenate(meshes), leaf_target=16, shape=True)


@pytest.fixture
def flake():
    """The size-factor-2 flake (91 spheres at lat 4, lon 8, on the ground) at
    16x16: the benchmark configuration's generator, port and reference."""
    cfg = spd.sphereflake(2, lat=4, lon=8)
    cfg["render"] = dict(cfg["render"], width=16, height=16, chunk_pixels=64)
    return cfg, scenes.scene_inputs(cfg)


def test_flake_matches_the_reference(flake, monkeypatch):
    """A bf16 request over more groups than GLO_SMEM_LIMIT (stubbed to 64)
    runs B1 as the benchmark cell does at full size; two ticks through the
    port's normal path match the reference on every slot."""
    cfg, inputs = flake
    monkeypatch.setattr(trace_bf16, "GLO_SMEM_LIMIT", 64)
    mods = port.load()
    scene, cam, _ = port.build_scene(mods, inputs, cfg["build"], "cpu")
    assert scene.dense.two_level and scene.dense.n_instances == 92
    assert scene.dense.n_groups > 64
    rcfg = port.render_config(mods, cfg, {"leaf_precision": "bf16"})
    r = Renderer(scene, cam, rcfg, device="cpu")
    ticks = []
    b1, b2 = sum(trace.PLAIN_CALLS.values()), sum(trace_bf16.PLAIN_CALLS.values())
    for _ in range(2):
        before, sample = r.film, r.sample
        img = r.tick(SEED)
        ticks.append((sample, before, r.film, img))
    assert sum(trace.PLAIN_CALLS.values()) > b1
    assert sum(trace_bf16.PLAIN_CALLS.values()) == b2
    off, total = frames.compare_ticks(geometry.bake(inputs, "cpu"), cfg["render"], SEED,
                                      ticks, 256)
    assert total == 512
    assert off == 0


@pytest.mark.parametrize("precision,b2", [("bf16", True), ("f32", False)])
def test_build_span_and_table_bytes(flake, precision, b2):
    """``pbrt.build`` names the BLASes, triangles, groups and workers;
    ``pbrt.tick``'s ``table_bytes`` is the bytes of B1's tables (B2's adds
    its own). One bounce at 4x4: the counts do not depend on the frame."""
    cfg, inputs = flake
    cfg = dict(cfg, render=dict(cfg["render"], width=4, height=4, bounces=1))
    mods = port.load()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            scene, cam, _ = port.build_scene(mods, inputs, cfg["build"], "cpu")
            r = Renderer(scene, cam, port.render_config(mods, cfg, {"leaf_precision": precision}),
                         device="cpu")
            r.tick(SEED)
        recs = profiling.spans()
    finally:
        profiling.reset()
    build = [x for x in recs if x["name"] == "pbrt.build"]
    assert len(build) == 1
    assert build[0]["attrs"] == {"blas": 92, "tris": 91 * 64 + 2,
                                 "groups": scene.dense.n_groups, "workers": 0}
    assert scenes.triangle_count(inputs) == 91 * 64 + 2
    d = scene.dense
    want = d.nodes16.nbytes + d.inst16.nbytes + d.leaf_rec.nbytes
    if b2:
        want += d.glo.nbytes + d.pids_c.nbytes + d.groups_bf2.nbytes
    tick = [x for x in recs if x["name"] == "pbrt.tick"]
    assert [x["attrs"]["table_bytes"] for x in tick] == [want]
    json.dumps(tick[0]["attrs"])
