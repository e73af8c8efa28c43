"""The SPD ``balls`` deployment (configuration ``spd_balls_sf4_512``, cell
``big-instanced-bf16``): its generator, the committed file, the cell's place
in ``BENCHMARK.json``, the reader of ``traversal_table_mb.frame``, and the
check against a fault.

``sphereflake(size_factor)`` writes the configuration. Regenerate the
committed file with

    python3 -m pbrt_bench.tests.test_spd_balls

from the repository's root. The flake follows Haines' ``balls.c`` (Standard
Procedural Databases, IEEE CG&A 1987): a sphere of radius r has 9 children
of radius r/3, their centres at r + r/3 along 9 directions of its own frame,
whose pole points away from its parent (the root's pole is +z). The 9
directions are three ``trio_dir`` vectors, rotated by asin(2/sqrt 6) about
(1, -1, 0) (right-handed), copied at 0, 120 and 240 degrees about z: 6 on
the equator, 60 degrees apart, and 3 at 54.7 degrees above it, 120 degrees
apart. SPD's z-up world is turned to the port's y-up by (x, y, z) ->
(x, z, -y).
"""

from __future__ import annotations

import json
import math
import sys
import types

import numpy as np
import pytest
import torch

from pbrt_bench import harness, scenes
from pbrt_bench.drivers import frames
from pbrt_bench.tests.bench_fixtures import SEED, card  # noqa: F401 (fixture)
from pbrt_bench.run import Context

CONFIG = "spd_balls_sf4_512"
CELL = "big-instanced-bf16"
FRAME_CELLS = ["bench-bf16-frames", "cornell-bf16-frames", "bench-f32-frames",
               "game-bf16-moving"]
JOINS = ["frame_ms", "frame_ms_p95", "kernel_launches.frame", "host_syncs.frame",
         "glue_device_ms.frame", "traversal_device_ms.frame", "traversal_roofline_pct.frame",
         "device_idle_pct.frame", "film_host_ms.frame", "host_reads.frame",
         "host_wait_ms.frame", "graph_replay_pct.frame"]
STAYS_OUT = ["live_lane_pct.frame", "closest_host_ms.frame", "occlusion_host_ms.frame",
             "shade_host_ms.frame"]
READER = "traversal_table_mb.frame"

SPD_FROM = (2.1, 1.3, 1.7)
SPD_LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
SPD_FOV_DEG = 45.0
# the port's pinhole camera: a screen plane at distance 2 with half extents
# aspect x 1, so tan(half the vertical field) = 1/2
PORT_TAN_HALF_FOV = 0.5
GROUND_Z = -0.5
GROUND_HALF = 12.0
LIGHT_COLOR = [12.0, 12.0, 12.0]
SPHERE = {"base_color": [1.0, 0.9, 0.7], "metalness": 0.5, "roughness": 0.3}
GROUND = {"base_color": [1.0, 0.75, 0.33], "metalness": 0.0, "roughness": 1.0}
DIGITS = 12


def _axis_rotation(axis, angle) -> np.ndarray:
    """Right-handed rotation by ``angle`` about ``axis``."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    t = 1.0 - c
    return np.array([[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                     [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                     [t * x * z - s * y, t * y * z + s * x, t * z * z + c]])


def child_directions() -> np.ndarray:
    """``balls.c``'s 9 child directions in a sphere's own frame (pole +z)."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]]) @ _axis_rotation(
        (1.0, -1.0, 0.0), math.asin(2.0 / math.sqrt(6.0))).T
    return np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0), k * 2.0 * math.pi / 3.0).T
                           for k in range(3)])


def _frame_of(pole) -> np.ndarray:
    """``balls.c``'s rotation from +z to ``pole``."""
    if pole[2] >= 1.0:
        return np.eye(3)
    if pole[2] <= -1.0:
        return _axis_rotation((0.0, 1.0, 0.0), math.pi)
    return _axis_rotation(np.cross((0.0, 0.0, 1.0), pole), math.acos(pole[2]))


def flake_spheres(size_factor: int) -> list[tuple]:
    """(centre, radius, level, parent index) of every sphere, in SPD's z-up
    world, depth first as ``balls.c`` outputs them (parent -1 for the root)."""
    dirs = child_directions()
    out = []

    def emit(center, radius, pole, level, parent):
        me = len(out)
        out.append((center, radius, level, parent))
        if level == size_factor:
            return
        for d in dirs @ _frame_of(pole).T:
            emit(center + d * (radius * (1.0 + 1.0 / 3.0)), radius / 3.0, d, level + 1, me)

    emit(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]), 0, -1)
    return out


def _y_up(p) -> list[float]:
    return [round(float(p[0]), DIGITS) + 0.0, round(float(p[2]), DIGITS) + 0.0,
            round(float(-p[1]), DIGITS) + 0.0]


def sphereflake(size_factor: int, lat: int = 12, lon: int = 24) -> dict:
    """The configuration of SPD ``balls`` at ``size_factor``: one sphere model
    per flake sphere (``lat`` x ``lon`` UV sphere) and a ground quad, each
    with one identity instance, the three SPD lights and the SPD view."""
    spheres = flake_spheres(size_factor)
    models = [dict({"mesh": {"kind": "sphere", "center": _y_up(c), "radius": round(r, DIGITS),
                             "lat": lat, "lon": lon}}, **SPHERE)
              for c, r, _, _ in spheres]
    g = GROUND_HALF
    corners = [(g, g, GROUND_Z), (-g, g, GROUND_Z), (-g, -g, GROUND_Z), (g, -g, GROUND_Z)]
    models.append(dict({"mesh": {"kind": "quad", "corners": [_y_up(p) for p in corners]}},
                       **GROUND))
    scale = math.tan(math.radians(SPD_FOV_DEG / 2.0)) / PORT_TAN_HALF_FOV
    n_tris = len(spheres) * 2 * lat * lon + 2
    return {
        "name": CONFIG,
        "source": "Haines, A Proposal for Standard Graphics Environments, IEEE CG&A 7(11), "
                  "1987: SPD balls.c (sphereflake), size factor 4, its view, lights and floor",
        "reduced": [],
        "assumed": {
            "tessellation": f"each sphere a {lat}x{lon} UV sphere, {2 * lat * lon} triangles "
                            "(the bench scene's uv_sphere; the pole rows' triangles are "
                            "degenerate, as in the bench sphere)",
            "meshes": "one mesh per SPD object, each in its own BLAS under one TLAS, as a "
                      "polygon export loads them; not one sphere instanced 7,381 times",
            "axes": "SPD's z-up world turned to the port's y-up: (x, y, z) -> (x, z, -y)",
            "camera": f"the port's pinhole camera sees tan(half field) = {PORT_TAN_HALF_FOV}, "
                      f"not SPD's {SPD_FOV_DEG:g} degrees, so the eye is moved toward the "
                      f"origin by {scale:.6f} along SPD's view line, framing the flake as "
                      "SPD's view does",
            "lights": f"SPD's three point lights, each of colour {LIGHT_COLOR} (SPD gives "
                      "positions only)",
            "materials": "SPD's NFF surfaces as recalled (spheres 1 0.9 0.7 with Kd 0.5, "
                         "Ks 0.5; floor 1 0.75 0.33, Kd 0.8, Ks 0) mapped to base colour, "
                         f"metalness and roughness: spheres {SPHERE}, ground {GROUND}",
            "background": "none (SPD's sky blue is for display only, not timings): "
                          "skybox off, missed rays black",
            "flake": "the 9 child directions as balls.c builds them (trio_dir, "
                     "asin(2/sqrt 6) about (1, -1, 0), copies at 0/120/240 degrees about "
                     "z), the rotation taken right-handed, so that 6 lie on the equator "
                     "and 3 on the far hemisphere",
        },
        "limits_of_this_scene": (
            f"{len(spheres):,} spheres and a ground quad, {n_tris:,} unique triangles in "
            f"{len(models):,} BLAS under one TLAS: ~413,000 leaf groups (56 a sphere), B1's tables "
            "~340 MB, ~7x the H100's 50 MB L2; above GLO_SMEM_LIMIT (8,192 groups) a bf16 "
            "request runs B1, the exact f32 engine"),
        "render": {"width": 512, "height": 512, "bounces": 4, "antialias": True,
                   "one_shadow_ray": True, "skybox": False, "chunk_pixels": 65536},
        "build": {"flatten": False, "dense_leaf_target": 16, "blas_workers": "auto"},
        "models": models,
        "instances": [{"model": k} for k in range(len(models))],
        "lights": {"point_pos": [_y_up(p) for p in SPD_LIGHTS],
                   "point_color": [LIGHT_COLOR] * len(SPD_LIGHTS)},
        "camera": {"pos": _y_up(np.asarray(SPD_FROM) * scale), "target": [0.0, 0.0, 0.0]},
    }


def dumps(cfg: dict) -> str:
    """The configuration as committed: one model or instance a line."""
    lines = ["{"]
    keys = list(cfg)
    for k in keys:
        v = cfg[k]
        end = "," if k != keys[-1] else ""
        if k in ("models", "instances"):
            rows = ",\n".join("    " + json.dumps(x) for x in v)
            lines.append(f"  {json.dumps(k)}: [\n{rows}\n  ]{end}")
        else:
            lines.append(f"  {json.dumps(k)}: {json.dumps(v)}{end}")
    return "\n".join(lines + ["}"]) + "\n"


def _tiny(size_factor=2, width=16, height=16):
    cfg = sphereflake(size_factor, lat=4, lon=8)
    cfg["render"] = dict(cfg["render"], width=width, height=height, chunk_pixels=64)
    return cfg


def moved_last_level(cfg: dict, size_factor: int) -> dict:
    """The fault: ``cfg`` with every sphere of the flake's last level moved
    by its radius (along SPD's +x, the port's +x)."""
    out = json.loads(json.dumps(cfg))
    for (c, r, level, _), m in zip(flake_spheres(size_factor), out["models"]):
        if level == size_factor:
            m["mesh"]["center"][0] += r
    return out


def _context(cfg, device, seed=SEED, slots=None, monkeypatch=None):
    """A Context of the cell whose configuration is ``cfg``."""
    real = scenes.load_json

    def load_json(kind, name):
        return cfg if (kind, name) == ("configs", CONFIG) else real(kind, name)
    monkeypatch.setattr(scenes, "load_json", load_json)
    ctx = Context(CELL, seed, device)
    if slots is not None:
        ctx.traffic = dict(ctx.traffic, check={"slots": slots})
    return ctx


def reading(ctx, program_cfg=None, iterations=1) -> dict:
    """The cell's check after set-up and ``iterations`` ticks, with the
    program built from ``program_cfg``'s scene (default: the cell's own)."""
    true_inputs = ctx.inputs
    if program_cfg is not None:
        ctx.inputs = scenes.scene_inputs(program_cfg)
    drv = ctx.driver()
    drv.setup()
    for _ in range(iterations):
        drv.iterate()
    drv.release()
    ctx.inputs = true_inputs
    return drv.check(frames.integrator.QueryCount())


# -- the generator -----------------------------------------------------------

def test_child_directions():
    dirs = child_directions()
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-12)
    equator = np.abs(dirs[:, 2]) < 1e-12
    assert equator.sum() == 6
    np.testing.assert_allclose(dirs[~equator, 2], math.sqrt(2.0 / 3.0), atol=1e-12)
    az = np.sort(np.degrees(np.arctan2(dirs[equator, 1], dirs[equator, 0])) % 360.0)
    np.testing.assert_allclose(np.diff(az), 60.0, atol=1e-9)
    az = np.sort(np.degrees(np.arctan2(dirs[~equator, 1], dirs[~equator, 0])) % 360.0)
    np.testing.assert_allclose(np.diff(az), 120.0, atol=1e-9)


def test_flake_at_size_factor_4():
    """7,381 spheres; radii r/3 a level; each child tangent to its parent and
    none toward it (its direction meets the parent's pole at 90 degrees or
    less, to 1e-7: a pole within 1e-16 of +z takes balls.c's general
    rotation, acos(1 - 1e-16) ~ 1.5e-8 rad about an axis of rounding)."""
    spheres = flake_spheres(4)
    assert len(spheres) == 7381 == sum(9 ** k for k in range(5))
    assert [sum(1 for s in spheres if s[2] == k) for k in range(5)] == [9 ** k for k in range(5)]
    for c, r, level, parent in spheres:
        assert r == pytest.approx(0.5 / 3 ** level, rel=1e-12)
        if parent < 0:
            continue
        pc, pr, _, grand = spheres[parent]
        assert np.linalg.norm(c - pc) == pytest.approx(pr + r, rel=1e-12)
        pole = np.array([0.0, 0.0, 1.0]) if grand < 0 else pc - spheres[grand][0]
        assert np.dot(c - pc, pole) / np.linalg.norm(c - pc) / np.linalg.norm(pole) >= -1e-7


def test_committed_file_is_generated():
    cfg = sphereflake(4)
    assert scenes.load_json("configs", CONFIG) == cfg
    assert len(cfg["models"]) == len(cfg["instances"]) == 7382
    assert len(cfg["source"]) <= 200
    tris = sum(2 * m["mesh"]["lat"] * m["mesh"]["lon"] if m["mesh"]["kind"] == "sphere" else 2
               for m in cfg["models"])
    assert tris == 4_251_458


def test_ground_faces_up_and_flake_sits_on_it():
    inputs = scenes.scene_inputs(_tiny(1))
    ground = inputs["models"][-1]
    np.testing.assert_allclose(ground["face_normals"], [[0.0, 1.0, 0.0]] * 2, atol=1e-7)
    lowest = min(m["corners"][:, 1].min() for m in inputs["models"][:-1])
    assert lowest >= GROUND_Z - 1e-6


# -- the cell in BENCHMARK.json ------------------------------------------------

def test_cell_in_the_benchmark():
    bench = harness.benchmark()
    cfg = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert cfg["file"] == f"pbrt_bench/configs/{CONFIG}.json" and cfg["reduced"] == []
    w = next(x for x in bench["workloads"] if x["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "bf16-frames", 1)
    assert len(w["why"]) <= 200
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert listed == set(JOINS) | {"setup_s", READER}
    for name in STAYS_OUT:
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        assert CELL not in m["workloads"]
    m = next(x for x in bench["per_layer"] if x["name"] == READER)
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "MB", "lower", "program_counter", "kernels B1 and B2", "frame_ms")
    assert m["workloads"] == FRAME_CELLS + [CELL]


# -- the reader ----------------------------------------------------------------

def _stub_run(monkeypatch, attrs):
    from pbrt_bench.tests.test_spans import fake_run
    spans = harness.load_module("metrics", "spans")
    recs = [dict(name="pbrt.tick", parent=-1, tick=k, start_ns=0, end_ns=1, reads=0,
                 wait_ns=0, lanes=0, live=0, attrs=a) for k, a in enumerate(attrs)]
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        types.SimpleNamespace(spans=lambda: [dict(r) for r in recs]))
    return fake_run("frame", 2)


def test_reader_reads_the_ticks(monkeypatch):
    run = _stub_run(monkeypatch, [{"table_bytes": 340_000_000}, {"table_bytes": 340_000_000},
                                  {"table_bytes": 1}])
    assert harness.load_module("metrics", READER).read(run) == pytest.approx(340.0)


def test_reader_silent_on_a_program_without_it(monkeypatch):
    """The parent's ticks carry no ``table_bytes``: no reading, no error."""
    run = _stub_run(monkeypatch, [{"chunks": 4}, {"chunks": 4}])
    assert harness.load_module("metrics", READER).read(run) is None


# -- the check -------------------------------------------------------------------

@pytest.fixture
def tiny_b1(monkeypatch):
    """The size-factor-2 flake at 16x16, on the engine the cell runs: its
    few hundred groups over a GLO_SMEM_LIMIT stubbed to 64, so a bf16
    request runs B1 as at full size."""
    trace_bf16 = pytest.importorskip("physically_based_ray_tracer_tpu_torch.ops.trace_bf16")
    monkeypatch.setattr(trace_bf16, "GLO_SMEM_LIMIT", 64)
    cfg = _tiny()
    return cfg, _context(cfg, torch.device("cpu"), slots=256, monkeypatch=monkeypatch)


def test_sound_run_correct_at_a_tiny_size(tiny_b1):
    _, ctx = tiny_b1
    off, limit = reading(ctx)["pixels_off"]
    assert off <= limit


def test_fault_caught_at_a_tiny_size(tiny_b1):
    """The last level's spheres moved by a radius read above the limit."""
    cfg, ctx = tiny_b1
    off, limit = reading(ctx, moved_last_level(cfg, 2))["pixels_off"]
    assert off > limit


@pytest.mark.cuda
def test_fault_caught_on_card(card, monkeypatch):
    """At the cell's own size on the card, two seeds: the last level's
    spheres moved by a radius read above the limit; prints each reading as
    a JSON line (``pytest -s``)."""
    cfg = scenes.load_json("configs", CONFIG)
    program = moved_last_level(cfg, 4)
    for seed in (SEED, SEED + 1):
        ctx = _context(cfg, card, seed=seed, monkeypatch=monkeypatch)
        off, limit = reading(ctx, program)["pixels_off"]
        print(json.dumps({"cell": CELL, "seed": seed, "kind": "last level moved",
                          "pixels_off": off}), flush=True)
        assert off > limit
        torch.cuda.empty_cache()


if __name__ == "__main__":
    (harness.ROOT / "configs" / f"{CONFIG}.json").write_text(dumps(sphereflake(4)))
