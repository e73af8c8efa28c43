"""Port host-side builders vs the JAX package's: byte-identical tables."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from bench import build_bench_scene as jax_bench_scene  # noqa: E402
from physically_based_ray_tracer_tpu.bvh import dense as jdense  # noqa: E402
from physically_based_ray_tracer_tpu.scene import procedural as jproc  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import build_scene as jbuild_scene  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import (  # noqa: E402
    build_scene_instanced as jbuild_scene_instanced)
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene import procedural as tproc  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene, build_scene_instanced, scene_from_numpy)
from tests import scenes  # noqa: E402
from tests.torch_port import (instanced_parts, port_instances,  # noqa: E402
                              port_models, scene_arrays)

DENSE_FIELDS = ("nodes16", "groups", "inst16", "prim_base", "world_lo", "world_hi")
SCENE_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "face_normal", "corner_normal",
                "corner_uv", "prim_model", "prim_inst", "mat_base", "mat_metal",
                "mat_rough", "mat_emissive", "mat_transmissive",
                "mat_reflectance", "mat_opacity", "tex_record", "sky")


def _same_bytes(got, want, what):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _same_dense(t, j):
    for f in DENSE_FIELDS:
        _same_bytes(getattr(t, f), getattr(j, f), f)
    # the bf16 engine's tables: groups_bf bit for bit (int16 views)
    _same_bytes(t.groups_bf.view(torch.int16), np.asarray(j.groups_bf).view(np.int16),
                "groups_bf")
    _same_bytes(t.glo, j.glo, "glo")
    _same_bytes(t.pids_c, j.pids_c, "pids_c")


def _same_scene(t, j):
    _same_dense(t.dense, j.dense)
    for f in SCENE_FIELDS:
        _same_bytes(getattr(t, f), getattr(j, f), f)
    np.testing.assert_array_equal(t.texel_pool.numpy(),
                                  np.asarray(j.texel_pool).astype(np.int64))
    for f in ("point_pos", "point_color", "point_active", "dir_pos", "dir_color",
              "spot_pos", "spot_color", "spot_rot", "area_pos", "area_color",
              "area_u", "area_v"):
        _same_bytes(getattr(t.lights, f), getattr(j.lights, f), f)


def _tris():
    sph = jproc.make_sphere(radius=1.0, lat=12, lon=18)[0].reshape(-1, 3, 3)
    quad = jproc.make_quad([-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4])[0]
    return np.concatenate([sph, quad.reshape(-1, 3, 3)]).astype(np.float32)


@pytest.mark.parametrize("args", [
    ((0.5, -0.2, 0.1), 0.7, 5, 9), ((0, 0, 0), 1.0, 32, 64)])
def test_procedural_identical(args):
    center, radius, lat, lon = args
    for a, b in zip(tproc.make_sphere(center, radius, lat, lon),
                    jproc.make_sphere(center, radius, lat, lon)):
        _same_bytes(a, b, "sphere")
    quad = ([-1, 0, -2], [3, 0, -2], [3, 1, 2], [-1, 1, 2])
    for a, b in zip(tproc.make_quad(*quad), jproc.make_quad(*quad)):
        _same_bytes(a, b, "quad")


@pytest.mark.parametrize("leaf_target,shape", [(32, False), (16, True), (64, False)])
def test_build_dense_identical(leaf_target, shape):
    tri = _tris()
    t, tdepth = tdense.build_dense(tri, leaf_target=leaf_target, shape=shape)
    j, jdepth = jdense.build_dense(tri, leaf_target=leaf_target, shape=shape)
    _same_dense(t, j)
    assert tdepth == jdepth
    assert t.stack_need <= tdepth
    # the leaf-shaping cost diagnostic, on the same tree
    nodes, segs, _, _, _ = tdense._build_core(tri, leaf_target)
    assert tdense.dense_sweep_cost(nodes, segs, None, None) == \
        jdense.dense_sweep_cost(nodes, segs, None, None)


def test_build_dense_tlas_identical():
    models, instances, _, _ = instanced_parts()
    mesh_tris = [m.corners.reshape(-1, 3, 3) for m in models]
    inst_mesh = [i.model for i in instances]
    transforms = np.stack([i.transform for i in instances])
    t, tmeta, tdepth = tdense.build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                               leaf_target=16, shape=True)
    j, jmeta, jdepth = jdense.build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                               leaf_target=16, shape=True)
    _same_dense(t, j)
    assert tdepth == jdepth and tmeta.tlas_cap == jmeta.tlas_cap
    assert t.two_level and t.n_instances == len(instances)
    assert t.stack_need <= tdepth


@pytest.mark.parametrize("flatten", ["auto", True])
def test_bench_scene_identical(flatten):
    """The benchmark scene: two-level under flatten="auto" (369 nodes, 361
    groups, 10 instances), one-level when forced flat."""
    t, tcam, tdepth = build_bench_scene(flatten=flatten, device="cpu")
    j, jcam, jdepth = jax_bench_scene(flatten=flatten)
    _same_scene(t, j)
    assert tdepth == jdepth
    _same_bytes(tcam.pos, jcam.pos, "cam.pos")
    if flatten == "auto":
        assert (t.dense.n_nodes, t.dense.n_groups, t.dense.n_instances) == (369, 361, 10)


@pytest.mark.parametrize("which", ["sphere", "cornell"])
def test_test_scenes_identical(which):
    """tests/scenes.py scenes: the port's build_scene from the same models."""
    built = {}

    def capture(models, instances, lights=None, sky=None, **kw):
        built.update(models=models, instances=instances)
        return jbuild_scene(models, instances, lights, sky=sky, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(scenes, "build_scene", capture)
    try:
        jscene, _ = (scenes.sphere_scene() if which == "sphere"
                     else scenes.cornell_scene())
    finally:
        mp.undo()
    lights = scene_from_numpy(scene_arrays(jscene), device="cpu").lights
    if which == "sphere":     # the port's own LightSet.make + pad_points
        lights = LightSet.make(
            point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
            dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
            spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
            device="cpu").pad_points(4)
    tscene, _ = build_scene(port_models(built["models"]),
                            port_instances(built["instances"]), lights, device="cpu")
    _same_scene(tscene, jscene)


def test_instanced_auto_flatten_identical():
    """build_scene_instanced(flatten="auto") flattens a small scene exactly
    as the JAX package does."""
    models, instances, lights, _ = instanced_parts()
    j, jmeta, jdepth = jbuild_scene_instanced(models, instances, lights,
                                              legacy_bvh=False, flatten="auto")
    tl = scene_from_numpy(scene_arrays(j), device="cpu").lights
    t, thandle, tdepth = build_scene_instanced(port_models(models),
                                               port_instances(instances), tl,
                                               legacy_bvh=False, flatten="auto",
                                               device="cpu")
    _same_scene(t, j)
    assert (thandle.tlas_meta is None) == (jmeta.tlas_meta is None)
    assert tdepth == jdepth


@pytest.mark.parametrize("leaf_target", [1, 2, 5, 16, 128])
def test_bf16_packing_identical(leaf_target):
    """_pack_groups_bf on the JAX package's own groups array, over leaf
    periods c from 1 to 128 (1-2, 2-8, 2-16 and 128 in these builds): bf16 bits, group boxes and the compact prim-id
    table equal the JAX package's; _group_period reads each group's c."""
    tri = _tris()
    j, _ = jdense.build_dense(tri, leaf_target=leaf_target)
    groups = np.asarray(j.groups)
    gbf, glo, pids_c = tdense._pack_groups_bf(groups)
    jbf, jglo, jpids = jdense._pack_groups_bf(groups)
    _same_bytes(gbf.view(torch.int16), np.asarray(jbf).view(np.int16), "groups_bf")
    _same_bytes(glo, jglo, "glo")
    _same_bytes(pids_c, jpids, "pids_c")
    rows = groups.reshape(-1, tdense.GROUP_ROWS, tdense.LEAF_W)[:, 9, :]
    periods = [tdense._group_period(r) for r in rows]
    assert periods == [jdense._group_period(r) for r in rows]
    assert set(periods) <= {1, 2, 4, 8, 16, 32, 64, 128}
    # a port DenseBVH built from the JAX arrays keeps the bf16 bits as they are
    t = tdense.DenseBVH.from_numpy(
        *(np.asarray(getattr(j, f)) for f in DENSE_FIELDS),
        groups_bf=np.asarray(j.groups_bf), glo=np.asarray(j.glo),
        pids_c=np.asarray(j.pids_c), device="cpu")
    assert t.groups_bf.dtype == torch.bfloat16
    _same_dense(t, j)
