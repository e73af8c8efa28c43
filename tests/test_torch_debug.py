"""The per-pixel debugger and the debug-draw overlay of the port against the
JAX package: ``trace_pixel`` / ``format_trace`` / ``pixel_grid``, the
integrator's debug tap (``trace_paths(collect_debug=True)``), and
``utils/debug_draw.py`` (tests/test_debugger.py and
tests/test_debug_draw.py, replayed).

Tolerance: per-bounce records as the integrators' own agreement: integer
and boolean fields equal, float fields allclose at rtol 2e-4, atol 2e-5
(tests/test_torch_render.py's per-pixel tolerance; the two integrators run
the same float32 operations); the tapped radiance equals the untapped
integrator's bit for bit, and the pixel grid agrees with the JAX package's
as tests/test_torch_render.py's ``_agree``. The debug-draw functions are
numpy copies over a float32 camera basis: equal byte for byte."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh.builder import build_bvh as jbuild_bvh  # noqa: E402
from physically_based_ray_tracer_tpu.render import debugger as jdebugger  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu.utils import debug_draw as jdraw  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import debugger  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import trace_paths  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import debug_draw  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

EXACT = ("hit_prim", "hit_inst", "is_dielectric", "picked_specular", "alive_out", "bounce")


def _cfg(engine):
    return SLICE_CFG.replace(antialias=False, leaf_precision=engine)


def _same_records(got, want):
    assert len(got) == len(want)
    assert got[-1].keys() == {"radiance"} == want[-1].keys()
    for g, w in zip(got[:-1], want[:-1]):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in EXACT:
                assert np.array_equal(g[k], np.asarray(v)), (g["bounce"], k)
            else:
                np.testing.assert_allclose(g[k], np.asarray(v), rtol=2e-4, atol=2e-5,
                                           err_msg=f"bounce {g['bounce']} {k}")
    np.testing.assert_allclose(got[-1]["radiance"], want[-1]["radiance"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("engine,xy", [("f32", (8, 9)), ("f32", (3, 2)), ("bf16", (8, 9))],
                         ids=["f32-hit", "f32-sky", "bf16-hit"])
def test_trace_pixel_matches_jax(engine, xy):
    """trace_pixel's per-bounce records and final radiance equal the JAX
    package's on the same scene, pixel and key; format_trace prints the
    JAX package's text for the JAX package's records."""
    jscene, jcam = instanced_scene()
    cfg = _cfg(engine)
    x, y = xy
    want = jdebugger.trace_pixel(jscene, jcam, cfg, x, y, key=jax.random.key(1))
    got = debugger.trace_pixel(port_scene(jscene), port_camera(jcam), port_config(cfg),
                               x, y, key=1, device="cpu")
    _same_records(got, want)
    if xy == (8, 9):
        assert got[0]["hit_prim"] >= 0 and np.linalg.norm(got[0]["shad_n"]) > 0.9
    txt = debugger.format_trace(got)
    assert "bounce 0" in txt and "final radiance" in txt
    jrecs = [{k: np.asarray(v) for k, v in r.items()} for r in want]
    assert debugger.format_trace(jrecs) == jdebugger.format_trace(want)


@pytest.mark.parametrize("engine", ["f32", "bf16"])
def test_debug_tap_matches_untapped_integrator(engine):
    """The tap observes the integrator: with collect_debug=True the radiance
    and primary t of a batch of paths (dead lanes and all-miss slices
    included) equal the untapped run's bit for bit, the records are
    (bounces, B, ...), and the tapped run traces every bounce with no gate
    while the untapped run keeps its gates."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(_cfg(engine).replace(bounces=3))
    ids = torch.arange(0, cfg.n_pixels, 3, dtype=torch.int32)
    xs = torch.remainder(ids, cfg.width).float()
    ys = torch.div(ids, cfg.width, rounding_mode="floor").float()
    o, d = primary_rays(cam, xs, ys, cfg.width, cfg.height)
    mod = trace if engine == "f32" else trace_bf16
    mod.reset_counts()
    rad, hit = trace_paths(scene, cfg, o, d, ids, 1, 0)
    untapped = mod.PLAIN_CALLS["closest"]
    mod.reset_counts()
    rad_tap, hit_tap, dbg = trace_paths(scene, cfg, o, d, ids, 1, 0, collect_debug=True)
    assert torch.equal(rad, rad_tap) and torch.equal(hit.t, hit_tap.t)
    assert dbg["hit_t"].shape == (cfg.bounces, ids.shape[0])
    assert dbg["point"].shape == (cfg.bounces, ids.shape[0], 3)
    assert (~dbg["alive_out"][-1]).any() and (dbg["hit_prim"][0] < 0).any()
    # the tap traces every bounce, gate-free; the untapped run keeps its gates
    assert mod.PLAIN_CALLS["closest"] == cfg.bounces >= untapped


def test_pixel_grid_matches_jax():
    jscene, jcam = instanced_scene()
    cfg = SLICE_CFG
    want = jdebugger.pixel_grid(jscene, jcam, cfg, 8, 8, radius=3, key=jax.random.key(2))
    got = debugger.pixel_grid(port_scene(jscene), port_camera(jcam), port_config(cfg), 8, 8,
                              radius=3, key=2, device="cpu")
    assert got.shape == (6, 6, 3) and np.isfinite(got).all()
    _agree(got.reshape(-1, 3), np.asarray(want).reshape(-1, 3))


def _cams():
    return (JCamera.make(pos=(0, 2, 7), target=(0, 0, 0)),
            port_camera(JCamera.make(pos=(0, 2, 7), target=(0, 0, 0))))


def test_project_inverts_primary_rays():
    """tests/test_debug_draw.py's test, on the port, and its projections
    equal the JAX package's byte for byte."""
    jcam, cam = _cams()
    W, H = 128, 96
    xs = torch.tensor([10.0, 64.0, 100.0, 30.0])
    ys = torch.tensor([5.0, 48.0, 90.0, 70.0])
    o, d = primary_rays(cam, xs, ys, W, H)
    pts = (o + d * 3.7).numpy()
    px, py, front = debug_draw.project_points(cam, pts, W, H)
    assert front.all()
    np.testing.assert_allclose(px, xs.numpy(), atol=0.25)
    np.testing.assert_allclose(py, ys.numpy(), atol=0.25)
    want = jdraw.project_points(jcam, pts, W, H)
    for a, b in zip((px, py, front), want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    _, _, behind = debug_draw.project_points(cam, np.array([[0.0, 2.0, 9.0]]), 64, 64)
    assert not behind.any()


def test_draw_aabbs_matches_jax():
    """Wireframe pixels land on the image (a copy: the input stays black),
    byte-equal to the JAX package's overlay."""
    jcam = JCamera.make(pos=(0, 0, 5), target=(0, 0, 0))
    cam = port_camera(jcam)
    img = np.zeros((96, 128, 3), np.float32)
    lo, hi = np.array([[-1.0, -1, -1], [0.2, 0.1, -2]]), np.array([[1.0, 1, 1], [1.5, 0.9, -1]])
    out = debug_draw.draw_aabbs(img, cam, lo, hi, color=(0, 1, 0))
    assert (out[..., 1] > 0).sum() > 50
    assert (img == 0).all()
    assert out.tobytes() == jdraw.draw_aabbs(img, jcam, lo, hi, color=(0, 1, 0)).tobytes()


def test_bvh_level_boxes_matches_jax():
    tri = make_sphere(radius=1.0, lat=8, lon=10)[0].reshape(-1, 3, 3)
    jbvh = jbuild_bvh(tri, leaf_size=4)
    from physically_based_ray_tracer_tpu_torch.bvh.builder import build_bvh
    bvh = build_bvh(tri, leaf_size=4)
    boxes, children = bvh.nodes_box.numpy(), bvh.nodes_child.numpy()
    for level in (0, 2, 30):
        lo, hi = debug_draw.bvh_level_boxes(boxes, children, level)
        jlo, jhi = jdraw.bvh_level_boxes(jbvh.nodes_box, jbvh.nodes_child, level)
        assert lo.tobytes() == np.asarray(jlo).tobytes()
        assert hi.tobytes() == np.asarray(jhi).tobytes()
        assert (hi >= lo - 1e-6).all()
    assert debug_draw.bvh_level_boxes(boxes, children, 2)[0].shape[0] > 2
