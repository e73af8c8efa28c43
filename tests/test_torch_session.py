"""The port's EditSession against the JAX package's, on two copies of one
synthetic reference-format asset tree (written to ``tmp_path`` with the
JAX package's serialization writers and tests/test_torch_io.py's glTF
sphere: two GameObjects, lights of every kind, the camera, a sky): the same
edits write the same JSON bytes and give the same scene tables, and
``watch_once`` folds the same external edits in. tests/test_session.py's
checks (which need the reference assets) are replayed on the port.

Tolerance: tables byte for byte (the builders, the refresh and the JSON
writers are copies); a rendered frame of the live session and a fresh
session loading the written JSONs, on the port, at atol 1e-5
(tests/test_session.py's); the port's frame against the JAX package's at
the f32 engine's rtol 1e-3, atol 1e-4 (tests/test_tlas.py's)."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.scene import serialization as jser  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance  # noqa: E402
from physically_based_ray_tracer_tpu.session import EditSession as JEditSession  # noqa: E402
from physically_based_ray_tracer_tpu_torch.session import EditSession  # noqa: E402
from tests.test_torch_io import _write_tree  # noqa: E402
from tests.test_torch_lifecycle import _same_scene  # noqa: E402
from tests.torch_port import port_config  # noqa: E402

CFG = RenderConfig(width=16, height=16, bounces=1, antialias=False, skybox=False,
                   max_stack_depth=40, leaf_precision="f32")


@pytest.fixture()
def trees(tmp_path):
    """Two identical asset trees: (JAX package's root, port's root)."""
    return tuple(str(_write_tree(tmp_path / k)) for k in ("jax", "port"))


def _sessions(trees):
    return (JEditSession(trees[0], cfg=CFG),
            EditSession(trees[1], cfg=port_config(CFG), device="cpu"))


def _files(root):
    """Every JSON of the tree: relative path -> bytes."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".json"):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _same(js, ts):
    _same_scene(ts.renderer.scene, js.renderer.scene, bvh=True)
    for f in ("pos", "target", "fov", "distortion"):
        assert getattr(ts.renderer.camera, f).numpy().tobytes() == \
            np.asarray(getattr(js.renderer.camera, f)).tobytes(), f
    assert [i.name for i in ts.handle.instances] == [i.name for i in js.handle.instances]


def _same_render(js, ts):
    want, got = js.render(), ts.render()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    return got


def test_edits_match_jax(trees):
    """edit_object, edit_light (each kind, position and colour) and
    edit_camera in both sessions: the same JSON bytes on disk, the same
    tables, frames that agree; the written JSONs hold the edits
    (tests/test_session.py's write-back checks)."""
    js, ts = _sessions(trees)
    _same(js, ts)
    img0 = _same_render(js, ts)
    assert ts.handle.tlas_meta is not None
    for s in (js, ts):
        s.edit_object("BallA", position=(0.5, 0.2, 0.0))
    _same(js, ts)
    img1 = _same_render(js, ts)
    assert not np.allclose(img0, img1)
    assert _files(trees[0]) == _files(trees[1])
    with open(os.path.join(trees[1], "scene1", "BallA.json")) as f:
        d = json.load(f)
    assert d["positionX"] == 0.5 and d["positionY"] == 0.2
    for s in (js, ts):
        s.edit_light("directional", 0, color=(9.0, 1.0, 1.0))
        s.edit_light("point", 1, position=(-1.0, 2.5, 0.5))
        s.edit_light("spot", 0, rotation=(0.0, -1.0, 0.2), color=(4.0, 4.0, 6.0))
        s.edit_camera(pos=(0.0, 1.0, 5.0), target=(0.0, 0.0, 0.0))
    _same(js, ts)
    img2 = _same_render(js, ts)
    assert not np.allclose(img1, img2)
    assert ts.renderer.scene.lights.dir_color.device == torch.device("cpu")
    assert _files(trees[0]) == _files(trees[1])
    ldir = os.path.join(trees[1], "scene1", "directionallights")
    with open(os.path.join(ldir, sorted(os.listdir(ldir))[0])) as f:
        assert json.load(f)["cX"] == 9.0
    with open(os.path.join(trees[1], "prefabs", "camera.json")) as f:
        assert json.load(f)["pZ"] == 5.0
    # a fresh session loading the written JSONs agrees with the live state
    np.testing.assert_allclose(EditSession(trees[1], cfg=port_config(CFG),
                                           device="cpu").render(), img2, atol=1e-5)
    out = ts.capture(os.path.join(trees[1], "cap.png"))
    assert os.path.getsize(out) > 0


def _touch(p, dt=2.0):
    t = os.path.getmtime(p) + dt
    os.utime(p, (t, t))


def test_watch_once_folds_external_edits(trees):
    """External edits of a GameObject, a light and the camera, written into
    both trees: watch_once reports the same files and folds them in, giving
    the same tables; a second call finds nothing; the session's frame then
    equals a fresh session's over the edited tree."""
    js, ts = _sessions(trees)
    img0 = ts.render()
    assert js.watch_once() == [] and ts.watch_once() == []
    for root in trees:
        scene = os.path.join(root, "scene1")
        p = os.path.join(scene, "BallB.json")
        jser.save_gameobject_json(p, JInstance(0, position=(1.25, 0.1, -0.4),
                                               rotation=(0.0, 0.4, 0.0)))
        q = os.path.join(scene, "pointlights", "p0.json")
        jser.save_light_json(q, (1.0, 4.0, 1.0), (30.0, 25.0, 20.0))
        c = os.path.join(root, "prefabs", "camera.json")
        with open(c) as f:
            d = json.load(f)
        d["pY"] = 1.5
        with open(c, "w") as f:
            json.dump(d, f)
        for x in (p, q, c):
            _touch(x)
    changed = [sorted(os.path.relpath(p, root) for p in s.watch_once())
               for s, root in zip((js, ts), trees)]
    assert changed[0] == changed[1] == sorted(
        ["scene1/BallB.json", "scene1/pointlights/p0.json", "prefabs/camera.json"])
    _same(js, ts)
    assert ts.handle.instances[1].position[0] == 1.25
    img1 = _same_render(js, ts)
    assert not np.allclose(img0, img1)
    assert js.watch_once() == [] and ts.watch_once() == []
    fresh = EditSession(trees[1], cfg=port_config(CFG), device="cpu")
    np.testing.assert_allclose(fresh.render(), img1, atol=1e-5)
