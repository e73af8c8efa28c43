"""Asset and scene I/O of the port against the JAX package's loaders, on
files written to ``tmp_path``: the OBJ/MTL fixture of tests/test_obj.py,
the two-material glTF of ``test_gltf_multi_material_split`` (and a GLB
and a textured, indexed glTF), texture packing, the reference JSON
formats (tests/test_scene_io.py's round trips, replayed), and a whole
reference-format asset tree through ``load_reference_scene``, rendered by
both packages.

Tolerance: loaders and builders are numpy copies, so every table is equal
byte for byte; the render of the loaded scene as tests/test_torch_render.py's
``_agree``. Tests that need the reference assets skip without them, as the
JAX package's do."""

import base64
import dataclasses
import io
import json
import math
import os
import shutil
import struct
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.models import gltf as jgltf  # noqa: E402
from physically_based_ray_tracer_tpu.models import obj as jobj  # noqa: E402
from physically_based_ray_tracer_tpu.models import resources as jresources  # noqa: E402
from physically_based_ray_tracer_tpu.models import textures as jtextures  # noqa: E402
from physically_based_ray_tracer_tpu.render import integrator as jintegrator  # noqa: E402
from physically_based_ray_tracer_tpu.scene import lights as jlights  # noqa: E402
from physically_based_ray_tracer_tpu.scene import loader as jloader  # noqa: E402
from physically_based_ray_tracer_tpu.scene import serialization as jser  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance  # noqa: E402
from physically_based_ray_tracer_tpu_torch.models import gltf, obj, resources, textures  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render import integrator  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import lights, loader, serialization  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.scene import Instance  # noqa: E402
from tests.test_scene_io import REF_ASSETS  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.torch_port import SKY_FIXTURE, SLICE_CFG, port_config, scene_arrays  # noqa: E402

HELMET = os.path.join(REF_ASSETS, "prefabs/models/SciFiHelmet/SciFiHelmet.gltf")

OBJ = textwrap.dedent("""\
    # cube-ish: two materials, one face each + one unmatted triangle fan
    mtllib box.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vt 0 0
    vt 1 0
    vt 1 1
    vn 0 0 -1
    usemtl red
    f 1/1/1 2/2/1 3/3/1 4/1/1
    usemtl shiny
    f 1/1 2/2 5/3
    """)

MTL = textwrap.dedent("""\
    newmtl red
    Kd 0.9 0.1 0.1
    Ke 0.0 0.5 0.0
    Ns 10
    newmtl shiny
    Kd 0.2 0.2 0.8
    Pm 1.0
    Pr 0.05
    """)


def _same_model(a, b):
    """Two MeshModels (port, JAX) field for field, arrays byte for byte."""
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def _same_models(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_model(a, b)


@pytest.fixture()
def obj_dir(tmp_path):
    (tmp_path / "box.obj").write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    return tmp_path


def test_obj_matches_jax(obj_dir):
    p = str(obj_dir / "box.obj")
    got = obj.load_obj(p)
    _same_models(got, jobj.load_obj(p))
    red, shiny = got
    assert red.n_tris == 2 and shiny.n_tris == 1
    np.testing.assert_allclose(red.base_color, (0.9, 0.1, 0.1))
    np.testing.assert_allclose(shiny.roughness, 0.05)
    np.testing.assert_allclose(np.linalg.norm(shiny.normals, axis=1), 1.0, atol=1e-5)


def test_obj_negative_indices_and_dispatch(obj_dir, tmp_path):
    (tmp_path / "neg.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    _same_models(obj.load_obj(str(tmp_path / "neg.obj")),
                 jobj.load_obj(str(tmp_path / "neg.obj")))
    _same_models(obj.load_model(str(obj_dir / "box.obj")),
                 jobj.load_model(str(obj_dir / "box.obj")))
    with pytest.raises(ValueError):
        obj.load_model("thing.fbx")


def _two_material_doc():
    """test_gltf_multi_material_split's document."""
    tri = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    buf = base64.b64encode(tri.tobytes()).decode()
    return {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": f"data:application/octet-stream;base64,{buf}",
                     "byteLength": tri.nbytes}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 36}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 1], "max": [1, 1, 1]}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 0, 0, 1],
                                      "metallicFactor": 0.0}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0, 0, 1, 1],
                                      "metallicFactor": 1.0}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "material": 0},
            {"attributes": {"POSITION": 1}, "material": 1}]}],
    }


def test_gltf_multi_material_matches_jax(tmp_path):
    p = tmp_path / "two.gltf"
    p.write_text(json.dumps(_two_material_doc()))
    got = gltf.load_gltf_multi(str(p))
    _same_models(got, jgltf.load_gltf_multi(str(p)))
    assert len(got) == 2 and got[1].metalness == 1.0
    _same_model(gltf.load_gltf(str(p)), jgltf.load_gltf(str(p)))
    assert gltf.load_gltf(str(p)).n_tris == 2


def test_glb_matches_jax(tmp_path):
    """The same document as a GLB: JSON chunk + binary chunk."""
    doc = _two_material_doc()
    raw = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    doc["buffers"] = [{"byteLength": len(raw)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(raw), 0x004E4942) + raw)
    p = tmp_path / "two.glb"
    p.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    _same_models(gltf.load_gltf_multi(str(p)), jgltf.load_gltf_multi(str(p)))
    _same_model(gltf.load_gltf(str(p)), jgltf.load_gltf(str(p)))


def _png_bytes(rgb):
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(rgb).save(out, format="PNG")
    return out.getvalue()


def _write_sphere_gltf(path, textured=True):
    """A UV sphere as an indexed glTF (uint32 indices, normals, UVs) with a
    material; with ``textured``, an embedded base-colour PNG and a
    metallic-roughness PNG next to the file (a relative URI)."""
    corners, normals, uvs, _ = make_sphere(radius=0.8, lat=8, lon=12)
    idx = np.arange(corners.shape[0], dtype=np.uint32)
    blobs = [corners.astype(np.float32).tobytes(), normals.astype(np.float32).tobytes(),
             uvs.astype(np.float32).tobytes(), idx.tobytes()]
    offs = np.cumsum([0] + [len(b) for b in blobs])
    data = b"".join(blobs)
    n = corners.shape[0]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(data).decode(), "byteLength": len(data)}],
        "bufferViews": [{"buffer": 0, "byteOffset": int(offs[i]),
                         "byteLength": len(blobs[i])} for i in range(4)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": n, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": n, "type": "SCALAR"}],
        "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.5, 0.3, 1],
                                                "metallicFactor": 0.3,
                                                "roughnessFactor": 0.6}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                   "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    if textured:
        gen = np.random.default_rng(5)
        albedo = gen.integers(0, 256, (4, 8, 3), dtype=np.uint8)
        rma = gen.integers(0, 256, (2, 2, 4), dtype=np.uint8)
        (path.parent / "rma.png").write_bytes(_png_bytes(rma))
        doc["images"] = [{"uri": "data:image/png;base64,"
                                 + base64.b64encode(_png_bytes(albedo)).decode()},
                         {"uri": "rma.png"}]
        doc["textures"] = [{"source": 0}, {"source": 1}]
        pbr = doc["materials"][0]["pbrMetallicRoughness"]
        pbr["baseColorTexture"] = {"index": 0}
        pbr["metallicRoughnessTexture"] = {"index": 1}
    path.write_text(json.dumps(doc))
    return path


def test_textured_indexed_gltf_matches_jax(tmp_path):
    p = _write_sphere_gltf(tmp_path / "m" / "ball.gltf")
    got = gltf.load_gltf(str(p))
    _same_model(got, jgltf.load_gltf(str(p)))
    assert got.albedo_texture.shape == (4, 8) and got.rma_texture.shape == (2, 2)


def test_texture_packing_matches_jax(tmp_path):
    gen = np.random.default_rng(6)
    rgb = gen.integers(0, 256, (3, 5, 3), dtype=np.uint8)
    rgba = gen.integers(0, 256, (3, 5, 4), dtype=np.uint8)
    flt = gen.uniform(0, 1.2, (3, 5, 3)).astype(np.float32)
    for x in (rgb, rgba, flt):
        a, b = textures.pack_rgba_u32(x), jtextures.pack_rgba_u32(x)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    r, m, ao = (textures.pack_rgba_u32(gen.integers(0, 256, (4, 4, 3), dtype=np.uint8))
                for _ in range(3))
    for args in ((r, m, ao), (r, None, None), (None, m, None), (None, None, None)):
        a, b = textures.combine_rma(*args), jtextures.combine_rma(*args)
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    assert (textures.constant_texture((0.2, 0.5, 1.0), 3).tobytes()
            == jtextures.constant_texture((0.2, 0.5, 1.0), 3).tobytes())
    png = tmp_path / "t.png"
    png.write_bytes(_png_bytes(rgba))
    assert textures.load_texture(str(png)).tobytes() == jtextures.load_texture(str(png)).tobytes()
    assert textures.load_texture(str(tmp_path / "missing.png")) is None
    assert (textures.decode_image_bytes(png.read_bytes()).tobytes()
            == jtextures.decode_image_bytes(png.read_bytes()).tobytes())
    (tmp_path / "Ship_albedo.png").write_bytes(_png_bytes(rgb))
    rm, jrm = (resources.ResourceManager([str(tmp_path)]),
               jresources.ResourceManager([str(tmp_path)]))
    got = rm.get_surface("Ship", resources.TextureType.ALBEDO)
    assert got.tobytes() == jrm.get_surface("Ship", jresources.TextureType.ALBEDO).tobytes()
    assert rm.get_surface("Ship", resources.TextureType.NORMAL) is None
    assert [t.value for t in resources.TextureType] == [t.value for t in jresources.TextureType]


# --- tests/test_scene_io.py's round trips, replayed on the port --------------

def test_camera_roundtrip(tmp_path):
    cam = Camera.make(pos=(1.5, -2.0, 3.25), target=(0.5, 0.25, -1.0), device="cpu")
    p = str(tmp_path / "camera.json")
    serialization.save_camera_json(p, cam)
    cam2 = serialization.load_camera_json(p, device="cpu")
    np.testing.assert_allclose(cam2.pos.numpy(), cam.pos.numpy(), rtol=1e-6)
    np.testing.assert_allclose(cam2.target.numpy(), cam.target.numpy(), rtol=1e-6)
    jser.save_camera_json(str(tmp_path / "j.json"), JCamera.make((1.5, -2.0, 3.25),
                                                                 (0.5, 0.25, -1.0)))
    assert open(p).read() == open(tmp_path / "j.json").read()


def test_gameobject_roundtrip(tmp_path):
    inst = Instance(model=2, position=(1, 2, 3), rotation=(0.0, math.pi / 2, math.pi),
                    scale=(1, 1, 1))
    p = str(tmp_path / "obj.json")
    serialization.save_gameobject_json(p, inst)
    inst2 = serialization.load_gameobject_json(p)
    assert inst2.model == 2
    np.testing.assert_allclose(inst2.position, inst.position)
    np.testing.assert_allclose(inst2.rotation, inst.rotation, atol=1e-6)
    jser.save_gameobject_json(str(tmp_path / "j.json"),
                              JInstance(model=2, position=(1, 2, 3),
                                        rotation=(0.0, math.pi / 2, math.pi)))
    assert open(p).read() == open(tmp_path / "j.json").read()
    assert dataclasses.asdict(inst2) == dataclasses.asdict(jser.load_gameobject_json(p))


def test_light_json_format(tmp_path):
    p = str(tmp_path / "light.json")
    serialization.save_light_json(p, (1, 2, 3), (4, 5, 6), (0, -1, 0))
    with open(p) as f:
        d = json.load(f)
    assert d == {"pX": 1.0, "pY": 2.0, "pZ": 3.0, "cX": 4.0, "cY": 5.0,
                 "cZ": 6.0, "rX": 0.0, "rY": -1.0, "rZ": 0.0}
    jser.save_light_json(str(tmp_path / "j.json"), (1, 2, 3), (4, 5, 6), (0, -1, 0))
    assert open(p).read() == open(tmp_path / "j.json").read()


def _write_tree(root):
    """A reference-format asset tree: the default model path, two
    GameObjects, lights of every kind, the camera and the skydome."""
    _write_sphere_gltf(root / "prefabs/models/SciFiHelmet/SciFiHelmet.gltf", textured=False)
    scene = root / "scene1"
    for sub in ("pointlights", "directionallights", "spotlights", "arealights"):
        (scene / sub).mkdir(parents=True)
    jser.save_gameobject_json(str(scene / "BallA.json"),
                              JInstance(0, position=(-0.7, 0.0, 0.0), rotation=(0, 0.5, 0)))
    jser.save_gameobject_json(str(scene / "BallB.json"),
                              JInstance(0, position=(0.9, 0.2, -0.5), rotation=(0.3, 0, math.pi)))
    jser.save_light_json(str(scene / "pointlights/p0.json"), (2, 3, 2), (20, 20, 20))
    jser.save_light_json(str(scene / "pointlights/p1.json"), (-2, 3, -1), (9, 10, 12))
    jser.save_light_json(str(scene / "directionallights/d0.json"), (5, 8, 3), (1.5, 1.4, 1.2))
    jser.save_light_json(str(scene / "spotlights/s0.json"), (0, 4, 0), (8, 8, 8), (0, -1, 0))
    jser.save_light_json(str(scene / "arealights/a0.json"), (0, 3, 0), (2, 2, 2))
    jser.save_camera_json(str(root / "prefabs/camera.json"),
                          JCamera.make((0.0, 1.0, 4.0), (0.0, 0.0, 0.0)))
    (root / "skydomes").mkdir()
    shutil.copy(SKY_FIXTURE, root / "skydomes/workshop3.hdr")
    return root


@pytest.mark.parametrize("include_point_lights", [True, False])
def test_scene_dir_and_lights_match_jax(tmp_path, include_point_lights):
    root = _write_tree(tmp_path)
    inst, ls = serialization.load_scene_dir(str(root / "scene1"), include_point_lights,
                                            device="cpu")
    jinst, jls = jser.load_scene_dir(str(root / "scene1"), include_point_lights)
    assert [dataclasses.asdict(i) for i in inst] == [dataclasses.asdict(i) for i in jinst]
    for f in dataclasses.fields(ls):
        np.testing.assert_array_equal(getattr(ls, f.name).numpy(), np.asarray(getattr(jls, f.name)))
    assert ls.n_point == (2 if include_point_lights else 0)
    full = lights.lights_from_reference_json(str(root / "scene1"), device="cpu")
    jfull = jlights.lights_from_reference_json(str(root / "scene1"))
    for f in dataclasses.fields(full):
        np.testing.assert_array_equal(getattr(full, f.name).numpy(),
                                      np.asarray(getattr(jfull, f.name)))
    assert full.n_area == 1


@pytest.mark.parametrize("instanced", [True, False])
def test_load_reference_scene_matches_jax(tmp_path, instanced):
    """The whole tree through load_reference_scene: every table byte for byte
    (the classic BVH included), the camera, the sky, the depth; then one
    render_sample of the loaded scene with its sky against the JAX
    package's."""
    root = _write_tree(tmp_path)
    scene, cam, depth = loader.load_reference_scene(str(root), instanced=instanced,
                                                    device="cpu")
    jscene, jcam, jdepth = jloader.load_reference_scene(str(root), instanced=instanced)
    assert depth == jdepth
    want = scene_arrays(jscene, bvh=True)
    for name, x in want.items():
        y = getattr(scene, name)
        if isinstance(x, dict):
            for k, v in x.items():
                got = getattr(y, k)
                if got.dtype == torch.bfloat16:
                    got = got.view(torch.int16)
                    v = v.view(np.int16)
                assert got.cpu().numpy().tobytes() == np.asarray(v).tobytes(), (name, k)
        else:
            assert y.cpu().numpy().astype(x.dtype).tobytes() == x.tobytes(), name
    np.testing.assert_array_equal(cam.pos.numpy(), np.asarray(jcam.pos))
    np.testing.assert_array_equal(cam.target.numpy(), np.asarray(jcam.target))
    assert scene.sky.shape == (16, 32, 3)
    cfg = SLICE_CFG.replace(skybox=True)
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    want_c, _ = jintegrator.render_sample(jscene, jcam, cfg, jax.random.key(0), 0,
                                          jnp.asarray(ids))
    got_c, _ = integrator.render_sample(scene, cam, port_config(cfg), 0, 0,
                                        torch.from_numpy(ids))
    _agree(got_c.numpy(), np.asarray(want_c))


def test_load_reference_scene_handle_matches_jax(tmp_path):
    """return_handle=True returns the InstancedScene that rebuild_scene
    needs, equal to the JAX package's: models, instances, TLAS constants
    and prim offsets; None with instanced=False."""
    root = _write_tree(tmp_path)
    *_, handle = loader.load_reference_scene(str(root), return_handle=True, device="cpu")
    *_, jhandle = jloader.load_reference_scene(str(root), return_handle=True)
    _same_models(handle.models, jhandle.models)
    assert [dataclasses.asdict(i) for i in handle.instances] == \
        [dataclasses.asdict(i) for i in jhandle.instances]
    for k in ("leaf_size", "legacy_bvh", "dense_leaf_target", "dense_shape"):
        assert getattr(handle, k) == getattr(jhandle, k), k
    for k in ("prim_start", "prim_count"):
        np.testing.assert_array_equal(getattr(handle, k), getattr(jhandle, k))
    meta, jmeta = handle.tlas_meta, jhandle.tlas_meta
    assert meta.tlas_cap == jmeta.tlas_cap
    for k in ("inst_mesh", "blas_root", "blas_lo", "blas_hi"):
        assert np.asarray(getattr(meta, k)).tobytes() == np.asarray(getattr(jmeta, k)).tobytes()
    assert loader.load_reference_scene(str(root), instanced=False, return_handle=True,
                                       device="cpu")[3] is None


@pytest.mark.skipif(not os.path.exists(HELMET), reason="reference assets absent")
def test_load_helmet_matches_jax():
    _same_models(obj.load_model(HELMET), jobj.load_model(HELMET))


@pytest.mark.skipif(not os.path.isdir(REF_ASSETS), reason="reference assets absent")
def test_load_reference_scene1_dir_matches_jax():
    inst, ls = serialization.load_scene_dir(os.path.join(REF_ASSETS, "scene1"), device="cpu")
    jinst, jls = jser.load_scene_dir(os.path.join(REF_ASSETS, "scene1"))
    assert [dataclasses.asdict(i) for i in inst] == [dataclasses.asdict(i) for i in jinst]
    np.testing.assert_array_equal(ls.point_pos.numpy(), np.asarray(jls.point_pos))
