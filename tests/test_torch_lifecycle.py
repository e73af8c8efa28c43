"""Scene lifecycle of the port against the JAX package: ``refresh_tlas``,
``rebuild_scene`` (the two-level refresh, the flattened fallback, the
``legacy_bvh`` rebuild, nothing moved, the mesh-membership asserts), the
handle that ``build_scene_instanced`` returns, and renders of moved scenes.

Tolerance: the builders and the refresh are numpy copies plus one torch
scatter, so every table equals the JAX package's byte for byte, after one
move and after several; a refreshed table also equals a from-scratch build
of the moved instances, shares every BLAS-side tensor with the table it
came from, and leaves that table's bytes as they were. Renders of a moved
scene: the f32 engine as tests/test_tlas.py's
``test_instanced_scene_renders_like_baked`` (rtol 1e-3, atol 1e-4); the
bf16 engine as tests/test_torch_render.py's ``_agree`` (at least 99% of
pixels allclose at rtol 2e-4, atol 2e-5, mean abs difference < 1e-3)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.bvh import dense as jdense  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import render_sample as jrender  # noqa: E402
from physically_based_ray_tracer_tpu.scene import scene as jscene_mod  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance  # noqa: E402
from physically_based_ray_tracer_tpu.utils.math import compose_trs  # noqa: E402
from physically_based_ray_tracer_tpu_torch.bvh import dense as tdense  # noqa: E402
from physically_based_ray_tracer_tpu_torch.config import RenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.scene import (  # noqa: E402
    Instance, build_scene, build_scene_instanced, rebuild_scene, world_tris)
from tests.test_tlas import _instances, _meshes  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.test_torch_tables import _same_dense  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_parts, port_camera,  # noqa: E402
                              port_config, port_handle, port_instances, port_models,
                              port_scene, scene_arrays)

# the BLAS-side tensors a refresh keeps (the same objects)
SHARED = ("groups", "groups_bf", "glo", "pids_c", "prim_base", "leaf_rec", "groups_bf2")


def _tf_moves():
    """Transforms of tests/test_tlas.py's 10 instances after one move, then
    after two frames in which most of them move (the TLAS changes shape)."""
    _, tf = _instances()
    one = tf.copy()
    one[4] = compose_trs((0.0, 5.0, 0.0), (0, 0, 0), (1.2, 1.2, 1.2))
    gen = np.random.default_rng(3)
    frames = [one]
    for _ in range(2):
        nxt = frames[-1].copy()
        for i in gen.choice(9, 6, replace=False):
            nxt[i] = compose_trs(tuple(gen.uniform(-6, 6, 3)), tuple(gen.uniform(-1, 1, 3)),
                                 (0.6, 0.6, 0.6))
        frames.append(nxt)
    return frames


def _same_tables(a, b):
    """Two port DenseBVHs: every tensor equal (bf16 bits included), the
    same stack need."""
    for k, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            w = getattr(b, k)
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16 else v,
                               w.view(torch.int16) if w.dtype == torch.bfloat16 else w), k
    assert a.stack_need == b.stack_need


def _snapshot(obj):
    """Copies of the tensors of a DenseBVH, or of a scene and its dense table."""
    snap = {k: v.clone() for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}
    if hasattr(obj, "dense"):
        snap.update({f"dense.{k}": v for k, v in _snapshot(obj.dense).items()})
    return snap


def _same_snapshot(obj, snap):
    for k, v in snap.items():
        got = obj.dense if k.startswith("dense.") else obj
        assert torch.equal(getattr(got, k.split(".")[-1]), v), k


def test_refresh_tlas_matches_jax():
    """Both packages' refresh of the same two-level table, over three frames:
    byte-equal tables, equal to a fresh build; ``stack_need`` = the whole
    table's; BLAS-side tensors shared; the old table untouched."""
    meshes = _meshes()
    inst_mesh, tf = _instances()
    jd, jmeta, _ = jdense.build_dense_tlas(meshes, inst_mesh, tf, leaf_target=32)
    td0, tmeta, _ = tdense.build_dense_tlas(meshes, inst_mesh, tf, leaf_target=32)
    _same_dense(td0, jd)
    snap = _snapshot(td0)
    td = td0
    for tf2 in _tf_moves():
        jd = jdense.refresh_tlas(jd, jmeta, tf2)
        td2 = tdense.refresh_tlas(td, tmeta, tf2)
        _same_dense(td2, jd)
        fresh, _, _ = tdense.build_dense_tlas(meshes, inst_mesh, tf2, leaf_target=32)
        _same_tables(td2, fresh)
        assert td2.stack_need == tdense.stack_need(
            td2.nodes16.numpy(), td2.inst16.numpy())
        assert all(getattr(td2, k) is getattr(td0, k) for k in SHARED)
        td = td2
    _same_snapshot(td0, snap)


def _deepest(nodes, inst, n, d):
    """Entries on the deepest path below node ``n`` (``d`` on the path down
    to it), following each instance leaf into its BLAS root behind a
    restore sentinel: the count ``stack_need`` must give."""
    best = d
    for side in range(2):
        code = int(np.rint(nodes[n, 12 + side]))
        if code == tdense.ABSENT:
            continue
        if code >= 0:
            best = max(best, _deepest(nodes, inst, code, d + 1))
        elif (-(code + 1)) % 2 == 1:
            root = int(np.rint(inst[(-(code + 1)) // 2 * tdense.INST_F + 12]))
            best = max(best, _deepest(nodes, inst, root, d + 2))
    return best


def test_stack_need_walks_every_path():
    """``stack_need`` (each BLAS's need counted once, then the TLAS) equals
    a walk of every path into every instance's BLAS, on the two-level table
    before and after each move, and on a single-level table."""
    meshes = _meshes()
    inst_mesh, tf = _instances()
    tables = [tdense.build_dense_tlas(meshes, inst_mesh, t, leaf_target=32)[0]
              for t in [tf] + _tf_moves()]
    soup = np.concatenate([np.asarray(m, np.float32).reshape(-1, 3, 3) for m in meshes])
    tables.append(tdense.build_dense(soup, leaf_target=16)[0])
    for t in tables:
        nodes = t.nodes16.numpy().reshape(-1, tdense.NODE_F)
        assert t.stack_need == _deepest(nodes, t.inst16.numpy(), 0, 1)


def _motion(moves):
    """Instance lists of instanced_parts()'s scene (JAX types), frame by
    frame: one sphere moved, three frames of several moving, or one frame
    with nothing moved."""
    _, instances, _, _ = instanced_parts()
    if moves == "none":
        return [list(instances)]
    first = [JInstance(0, position=(-1.5, 0.8, 0.3))] + instances[1:]
    if moves == "one":
        return [first]
    frames = [first]
    for k in range(2):
        cur = list(frames[-1])
        cur[1] = dataclasses.replace(cur[1], position=(0.5 + k, 0.2, -1.0 - k),
                                     rotation=(0.3, 0.7 + k, 0.1))
        cur[2] = dataclasses.replace(cur[2], position=(2.2, -0.2 + 0.5 * k, 0.8),
                                     scale=(0.9, 0.6, 0.6))
        frames.append(cur)
    return frames


def _same_scene(scene, jscene, bvh):
    for name, x in scene_arrays(jscene, bvh=bvh).items():
        y = getattr(scene, name)
        if isinstance(x, dict):
            for k, v in x.items():
                got = getattr(y, k)
                if got.dtype == torch.bfloat16:
                    got, v = got.view(torch.int16), v.view(np.int16)
                assert got.numpy().tobytes() == np.asarray(v).tobytes(), (name, k)
        else:
            assert y.numpy().astype(x.dtype).tobytes() == x.tobytes(), name




@pytest.mark.parametrize("layout,moves", [
    ("two-level", "one"), ("two-level", "several"), ("two-level", "none"),
    ("flattened", "one"), ("flattened", "none"), ("legacy_bvh", "several")])
def test_rebuild_scene_matches_jax(layout, moves):
    """rebuild_scene on the JAX package's tables and handle (port_handle) vs
    the JAX package's rebuild_scene, frame by frame: every table byte for
    byte (the classic BVH too with legacy_bvh); the shading arrays and a
    refreshed two-level table equal the port's own from-scratch build of
    the same instances; the two-level refresh shares
    the BLAS-side tensors and recounts stack_need; nothing moved keeps the
    arrays; the scene passed in is never written."""
    models, instances, jlights, _ = instanced_parts()
    legacy = layout == "legacy_bvh"
    flatten = layout == "flattened"
    jscene, jhandle, _ = jscene_mod.build_scene_instanced(
        models, instances, jlights, legacy_bvh=legacy, flatten=flatten)
    scene = port_scene(jscene, bvh=legacy)
    handle = port_handle(jhandle, jscene.dense)
    assert (handle.tlas_meta is None) == flatten
    for insts in _motion(moves):
        snap = _snapshot(scene)
        jscene = jscene_mod.rebuild_scene(jscene, jhandle, insts)
        new = rebuild_scene(scene, handle, port_instances(insts), device="cpu")
        _same_scene(new, jscene, legacy)
        _same_snapshot(scene, snap)
        fresh, _, _ = build_scene_instanced(
            port_models(models), port_instances(insts), scene.lights, legacy_bvh=legacy,
            flatten=flatten, device="cpu")
        for k in ("tri_v0", "tri_e1", "tri_e2", "face_normal", "corner_normal"):
            assert torch.equal(getattr(new, k), getattr(fresh, k)), k
        assert new.dense.stack_need == tdense.stack_need(new.dense.nodes16.numpy(),
                                                         new.dense.inst16.numpy())
        if layout != "flattened":
            # the refreshed two-level table is the fresh build's; a flattened
            # or classic rebuild starts from v0 + e1, v0 + e2 summed in f32
            # (as the JAX package's does), so only the JAX package's bytes
            # hold it
            _same_tables(new.dense, fresh.dense)
            assert all(getattr(new.dense, k) is getattr(scene.dense, k) for k in SHARED)
        if moves == "none":
            assert new.tri_v0 is scene.tri_v0 and new.corner_normal is scene.corner_normal
            if flatten:     # the table as it was: every tensor the same object
                assert all(v is getattr(scene.dense, k) for k, v in vars(new.dense).items()
                           if isinstance(v, torch.Tensor))
        assert [i.position for i in handle.instances] == [i.position for i in insts]
        scene = new


def test_rebuild_scene_asserts():
    """The mesh-membership asserts, as in the JAX package."""
    models, instances, jlights, _ = instanced_parts()
    jscene, jhandle, _ = jscene_mod.build_scene_instanced(models, instances, jlights,
                                                          legacy_bvh=False)
    scene, handle = port_scene(jscene), port_handle(jhandle, jscene.dense)
    swapped = [JInstance(1)] + instances[1:]
    for bad in (swapped, instances[:-1]):
        with pytest.raises(AssertionError):
            jscene_mod.rebuild_scene(jscene, jhandle, bad)
        with pytest.raises(AssertionError):
            rebuild_scene(scene, handle, port_instances(bad), device="cpu")


@pytest.mark.parametrize("engine", ["f32", "bf16"])
def test_moved_render_matches_jax(engine):
    """render_sample of the same moved two-level scene, rebuilt by each
    package, with the same key (f32 engine: rtol 1e-3, atol 1e-4; bf16
    engine: _agree)."""
    models, instances, jlights, jcam = instanced_parts()
    jscene, jhandle, _ = jscene_mod.build_scene_instanced(models, instances, jlights,
                                                          legacy_bvh=False)
    scene, handle = port_scene(jscene), port_handle(jhandle, jscene.dense)
    insts = _motion("several")[-1]
    jscene = jscene_mod.rebuild_scene(jscene, jhandle, insts)
    scene = rebuild_scene(scene, handle, port_instances(insts), device="cpu")
    cfg = SLICE_CFG.replace(leaf_precision=engine,
                            **({"bounces": 1} if engine == "bf16" else {}))
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    want, _ = jrender(jscene, jcam, cfg, jax.random.key(0), 0, jnp.asarray(ids))
    got, _ = render_sample(scene, port_camera(jcam), port_config(cfg), 0, 0,
                           torch.from_numpy(ids))
    want = np.asarray(want)
    assert want.mean() > 1e-3
    if engine == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    else:
        _agree(got.numpy(), want)


def test_instanced_scene_renders_like_baked():
    """tests/test_tlas.py's test of the same name, on the port: the
    instanced scene renders as the world-baked one, and after
    rebuild_scene moves a sphere, as the world-baked build of the moved
    instances (f32 engine, rtol 1e-3, atol 1e-4)."""
    models = port_models(instanced_parts()[0])
    lights = LightSet.make(point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
                           device="cpu").pad_points(4)
    insts = [Instance(0, position=(-1.5, 0, 0)),
             Instance(0, position=(1.5, 0, 0), scale=(0.7, 0.7, 0.7)), Instance(1)]
    cam = Camera.make(pos=(0, 1.5, 5), target=(0, 0, 0), device="cpu")
    cfg = RenderConfig(width=24, height=24, bounces=2, antialias=False, skybox=False,
                       accumulate=False, traversal="pallas", leaf_precision="f32",
                       max_stack_depth=24)
    ids = torch.arange(24 * 24, dtype=torch.int32)
    baked, _ = build_scene(models, insts, lights, device="cpu")
    inst_sc, handle, _ = build_scene_instanced(models, insts, lights, legacy_bvh=False,
                                               device="cpu")
    c_baked, _ = render_sample(baked, cam, cfg, 0, 0, ids)
    c_inst, _ = render_sample(inst_sc, cam, cfg, 0, 0, ids)
    np.testing.assert_allclose(c_inst.numpy(), c_baked.numpy(), rtol=1e-3, atol=1e-4)
    moved = [Instance(0, position=(-1.5, 0.8, 0.3)), insts[1], insts[2]]
    inst_sc2 = rebuild_scene(inst_sc, handle, moved, device="cpu")
    assert inst_sc2.dense.groups is inst_sc.dense.groups
    baked2, _ = build_scene(models, moved, lights, device="cpu")
    c_moved, _ = render_sample(inst_sc2, cam, cfg, 0, 0, ids)
    c_ref, _ = render_sample(baked2, cam, cfg, 0, 0, ids)
    assert not np.allclose(c_moved.numpy(), c_inst.numpy())
    np.testing.assert_allclose(c_moved.numpy(), c_ref.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_refreshed_and_refit_tables_on_gpu():
    """On the card: B1 and B2 on a refreshed two-level table equal the same
    kernels on a fresh build of the moved instances, and B1 on a refit
    single-level table equals its plain version (runs where a GPU is
    present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from physically_based_ray_tracer_tpu_torch.bvh.refit import refit_dense
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16
    from tests.test_refit_cache import _deform
    dev = torch.device("cuda")
    models, instances, jlights, jcam = instanced_parts()
    lights = port_scene(jscene_mod.build_scene_instanced(
        models, instances, jlights, legacy_bvh=False)[0]).lights.to(dev)
    scene, handle, _ = build_scene_instanced(port_models(models), port_instances(instances),
                                             lights, legacy_bvh=False, device=dev)
    insts = port_instances(_motion("several")[-1])
    moved = rebuild_scene(scene, handle, insts, device=dev)
    fresh, _, _ = build_scene_instanced(port_models(models), insts, lights,
                                        legacy_bvh=False, device=dev)
    gen = np.random.default_rng(4)
    o = torch.from_numpy(gen.normal(size=(4096, 3)).astype(np.float32) * 0.5).to(dev)
    o[:, 2] += 6.0
    d = torch.nn.functional.normalize(-o + torch.from_numpy(
        gen.normal(size=(4096, 3)).astype(np.float32)).to(dev), dim=1)
    for fn in (trace.sorted_closest_dense, trace_bf16.sorted_closest_bf16):
        a, b = fn(moved.dense, o, d), fn(fresh.dense, o, d)
        assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)
    flat, _ = build_scene(port_models(models), insts, lights, device=dev)
    tri = world_tris(flat.tri_v0, flat.tri_e1, flat.tri_e2)
    re = refit_dense(flat.dense, _deform(tri))
    tm = torch.full((4096,), 1e30, device=dev)
    *raw, _ = trace.plain_traverse(re, o, d, tm, closest=True)
    want = trace.to_hit(re, *raw)
    got = trace.intersect_closest_dense(re, o, d, tm)
    assert torch.equal(got.prim >= 0, want.prim >= 0)
    both = (got.prim >= 0) & (want.prim >= 0)
    assert torch.allclose(got.t[both], want.t[both], rtol=1e-6, atol=0.0)
