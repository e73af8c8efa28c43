"""The port's differentiable path (``diff/grad.py``) on the CPU.

Part 1 replays tests/test_grad.py on the port, test for test: the same
scene (a lat-10 / lon-12 sphere, one point light padded to 4 slots,
camera at (0, 0.5, 3.5)), built by the port's own builders, the same
config (12x12, 1 bounce, no AA, f32 engine) and the same tolerances
(``_fd_check``: rtol 0.08, atol 1e-5 against central differences; the TRS
bake rtol 2e-2, atol 5e-2; the 2-bounce gradients finite for every light
type).

Part 2 holds the port's gradient to ``jax.grad`` of the JAX package on the
same scene and parameters (the scene built by the JAX package and carried
over with ``tests/torch_port.py::port_scene``, the parameters with
``params_from_numpy``), elementwise at rtol 1e-3, atol 1e-6 (GRAD_RTOL,
GRAD_ATOL): the two integrators run the same float32 operations, so the
gradients agree to a few ulps of the loss's terms. Every parameter group
on the sphere scene with all four light types (CFG); the two-level
instanced scene of SLICE_CFG (2 bounces, AA, one shadow ray) for
instance_trs, point_color and base_color; and the bf16 engine on the
sphere scene. No path forks on a t-tie between the two traversals on these
scenes, so every element is compared.

Part 3 pins the detach: every traversal engine receives rays and t_max
that carry no autograd history while the loss's parameters need a
gradient."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig as JRenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.diff import grad as jgrad  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu.scene.lights import LightSet as JLightSet  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere as jmake_sphere  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance as JInstance  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import MeshModel as JMeshModel  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import build_scene as jbuild_scene  # noqa: E402
from physically_based_ray_tracer_tpu_torch.diff import grad as tgrad  # noqa: E402
from physically_based_ray_tracer_tpu_torch.diff.grad import (  # noqa: E402
    apply_params, render_color, trs_params_from_instances)
from physically_based_ray_tracer_tpu_torch.diff.inverse import (  # noqa: E402
    fit, make_sharded_train_step, make_train_step)
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16, trace_rows  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.procedural import make_quad, make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance, MeshModel,  # noqa: E402
                                                               build_scene)
from tests.scenes import TINY as JTINY  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_parts, instanced_scene,  # noqa: E402
                              port_camera, port_config, port_scene)

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6

# tests/test_grad.py's CFG (JCFG; CFG is the port's): tiny, 1 bounce, no AA,
# the f32 engine (the bf16 engine's edge-tie choice can flip a pixel's prim
# across an FD step)
JCFG = JRenderConfig(width=12, height=12, bounces=1, antialias=False,
                     skybox=False, max_stack_depth=24, gamma_corrected=False,
                     leaf_precision="f32")
CFG = port_config(JCFG)
TINY = port_config(JTINY)
IDS = torch.arange(CFG.n_pixels, dtype=torch.int32)


def _grad(f, x):
    xg = x.detach().clone().requires_grad_(True)
    return torch.autograd.grad(f(xg), xg)[0].numpy().astype(np.float64)


def _value(f, x):
    with torch.no_grad():
        return float(f(torch.tensor(x, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# Part 1: tests/test_grad.py on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=10, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5)
    lights = LightSet.make(point_pos=[[2, 3, 2]], point_color=[[15, 15, 15]],
                           device="cpu").pad_points(4)
    scene, _ = build_scene([sphere], [Instance(0)], lights, device="cpu")
    cam = Camera.make(pos=(0, 0.5, 3.5), target=(0, 0, 0), device="cpu")

    def render_mean(params):
        s, c = apply_params(scene, cam, params)
        return torch.mean(render_color(s, c, CFG, 0, 0, IDS))

    return scene, cam, render_mean


def _fd_check(f, x0, eps, rtol=0.08, atol=1e-5, min_grad=1e-7):
    """Central finite differences on every element of x0 (float64 steps,
    float32 renders), compared where the gradient is meaningfully nonzero."""
    g, fd, _ = tgrad.grad_check_fd(f, x0, eps=eps)
    mask = (np.abs(g) > min_grad) | (np.abs(fd) > min_grad)
    assert mask.any(), "gradient identically zero — nothing to check"
    np.testing.assert_allclose(g[mask], fd[mask], rtol=rtol, atol=atol)
    return g, fd


def test_grad_albedo(setup):
    scene, cam, render_mean = setup
    _fd_check(lambda x: render_mean({"base_color": x}), scene.mat_base, eps=1e-2)


def test_grad_roughness(setup):
    scene, cam, render_mean = setup
    _fd_check(lambda x: render_mean({"roughness": x}), scene.mat_rough, eps=1e-2,
              rtol=0.15)


def test_grad_light_intensity(setup):
    scene, cam, render_mean = setup
    _fd_check(lambda x: render_mean({"point_color": x}), scene.lights.point_color,
              eps=1e-1)


def test_grad_emissive(setup):
    scene, cam, render_mean = setup
    _fd_check(lambda x: render_mean({"emissive": x}), scene.mat_emissive + 0.5, eps=1e-2)


def test_grad_translation_nonzero(setup):
    """Translation: gradients flow through refine_hit and shading."""
    scene, cam, render_mean = setup
    g = _grad(lambda x: render_mean({"translation": x}), torch.zeros((1, 3)))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6


def test_grad_camera_pos(setup):
    scene, cam, render_mean = setup
    g = _grad(lambda x: render_mean({"camera_pos": x}), cam.pos)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-7


def test_inverse_rendering_recovers_albedo(setup):
    """Mini config #5: recover a perturbed albedo by gradient descent."""
    scene, cam, render_mean = setup
    with torch.no_grad():
        target = render_color(scene, cam, CFG, 0, 0, IDS)
    wrong = {"base_color": scene.mat_base * 0.4 + 0.3}
    params, losses = fit(scene, cam, CFG, wrong, target, IDS, steps=150, lr=0.01,
                         vary_sample=False)
    assert losses[-1] < losses[0] * 0.2
    np.testing.assert_allclose(params["base_color"].detach().numpy(),
                               scene.mat_base.numpy(), atol=0.1)


def _port_sphere_scene(lights=None):
    """tests/scenes.py's sphere_scene, by the port's builders."""
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=12, lon=16),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4)
    floor = MeshModel.from_fat(
        make_quad([-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    if lights is None:
        lights = LightSet.make(
            point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
            dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
            spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
            device="cpu").pad_points(4)
    scene, _ = build_scene([sphere, floor], [Instance(0), Instance(1)], lights,
                           device="cpu")
    return scene, Camera.make(pos=(0, 1, 4), target=(0, 0, 0), device="cpu")


def test_multibounce_gradients_finite_all_light_types():
    """Dead lanes must not carry hit_t = BVH_FAR into the NEE math (point =
    o + 1e30 d overflows and 0 x NaN is NaN in the backward pass): the
    2-bounce roughness gradient is finite for every light type."""
    cfg = TINY.replace(bounces=2)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    variants = {
        "spot": LightSet.make(spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]],
                              spot_rot=[[0, -1, 0]], device="cpu"),
        "full": None,
    }
    for name, lights in variants.items():
        scene, cam = _port_sphere_scene(lights)

        def loss_fn(rough):
            sc = dataclasses.replace(scene, mat_rough=rough)
            return torch.mean(render_color(sc, cam, cfg, 0, 0, ids) ** 2)

        g = _grad(loss_fn, scene.mat_rough)
        assert np.isfinite(g).all(), (name, g)


def test_grad_trs_bake_matches_fd(setup):
    """The differentiable TRS re-bake is pure math: its gradients match
    central differences at the bake level."""
    scene, cam, _ = setup
    trs0 = trs_params_from_instances(
        [Instance(0, position=(0.2, -0.1, 0.3), rotation=(0.3, 0.5, -0.2),
                  scale=(1.2, 0.8, 1.1))], device="cpu")
    rng = np.random.RandomState(0)
    w_v0 = torch.tensor(rng.randn(*scene.tri_v0.shape), dtype=torch.float32)
    w_fn = torch.tensor(rng.randn(*scene.face_normal.shape), dtype=torch.float32)

    def f_all(pos, rot, scl):
        s, _ = apply_params(scene, cam, {"instance_trs": {
            "position": pos, "rotation": rot, "scale": scl,
            "base_inv": trs0["base_inv"]}})
        return (torch.sum(w_v0 * s.tri_v0) + torch.sum(w_fn * s.face_normal)
                + torch.sum(s.tri_e1) + torch.sum(s.tri_e2))

    x0 = [trs0["position"].clone().requires_grad_(True),
          trs0["rotation"].clone().requires_grad_(True),
          trs0["scale"].clone().requires_grad_(True)]
    grads = torch.autograd.grad(f_all(*x0), x0)
    for a, name in enumerate(("position", "rotation", "scale")):
        g = grads[a].numpy().astype(np.float64)
        xn = x0[a].detach().numpy().astype(np.float64)
        eps = 1e-3
        fd = np.zeros_like(xn)
        for i in range(3):
            d = np.zeros_like(xn)
            d[0, i] = eps
            args_p = [v.detach().numpy().astype(np.float64) for v in x0]
            args_m = [v.detach().numpy().astype(np.float64) for v in x0]
            args_p[a] = xn + d
            args_m[a] = xn - d
            with torch.no_grad():
                fp = float(f_all(*[torch.tensor(v, dtype=torch.float32) for v in args_p]))
                fm = float(f_all(*[torch.tensor(v, dtype=torch.float32) for v in args_m]))
            fd[0, i] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=2e-2, atol=5e-2,
                                   err_msg=f"TRS bake grad mismatch: {name}")


def test_grad_rotation_scale_trs_render(setup):
    """Render-level rotation and scale gradients: finite, scale nonzero."""
    scene, cam, render_mean = setup
    trs0 = trs_params_from_instances([Instance(0)], device="cpu")
    g = _grad(lambda rot: render_mean({"instance_trs": {**trs0, "rotation": rot}}),
              trs0["rotation"])
    assert np.isfinite(g).all()
    g2 = _grad(lambda scl: render_mean({"instance_trs": {**trs0, "scale": scl}}),
               trs0["scale"])
    assert np.isfinite(g2).all()
    assert np.abs(g2).max() > 1e-6, "scale gradient identically zero"


def test_grad_rotation_fd(setup):
    """Euler-rotation gradient vs FD for a rotationally asymmetric object (a
    sphere rotated about an offset pivot). Detached sampling omits the
    visibility boundary term that FD also measures, so the contract is
    tests/test_grad.py's: finite; nonzero, sign-consistent with FD and
    within its scale on the components where FD is smooth."""
    scene, cam, render_mean = setup
    trs0 = trs_params_from_instances([Instance(0, position=(0.35, 0.1, 0.0))],
                                     device="cpu")

    def f(rot):
        return render_mean({"instance_trs": {**trs0, "rotation": rot}})

    g = _grad(f, trs0["rotation"])[0]
    x = trs0["rotation"].numpy().astype(np.float64)

    def fd_at(eps):
        fd = np.zeros(3)
        for i in range(3):
            dlt = np.zeros_like(x)
            dlt[0, i] = eps
            fd[i] = (_value(f, x + dlt) - _value(f, x - dlt)) / (2 * eps)
        return fd

    fd1 = fd_at(5e-3)
    fd2 = fd_at(2.5e-3)
    assert np.isfinite(g).all()
    smooth = np.abs(fd1 - fd2) < 0.5 * np.maximum(np.abs(fd1), np.abs(fd2)) + 1e-4
    mask = smooth & (np.abs(fd1) > 5e-4)
    assert smooth.any(), "every FD component straddles a visibility flip"
    if mask.any():
        assert (np.abs(g[mask]) > 1e-5).any(), \
            "rotation gradient is numerically dead where FD is live"
        consistent = (np.sign(g[mask]) == np.sign(fd1[mask])) | (np.abs(g[mask]) < 1e-4)
        assert consistent.all(), f"rotation gradient fights FD: g={g[mask]} fd={fd1[mask]}"
        assert (np.abs(g[mask]) <= np.abs(fd1[mask]) * 2.5 + 3e-3).all(), \
            f"gradient exceeds FD scale: g={g[mask]} fd={fd1[mask]}"


def test_grad_camera_lookat_chain_fd(setup):
    """Camera position and target gradients vs FD: the whole look-at chain
    (basis vectors, screen corners) is differentiable."""
    scene, cam, render_mean = setup
    for key_name, x0 in (("camera_pos", cam.pos), ("camera_target", cam.target)):
        f = lambda x: render_mean({key_name: x})
        g = _grad(f, x0)
        assert np.isfinite(g).all()
        eps = 2e-3
        fd = np.zeros(3)
        xn = x0.numpy().astype(np.float64)
        for i in range(3):
            dlt = np.zeros_like(xn)
            dlt[i] = eps
            fd[i] = (_value(f, xn + dlt) - _value(f, xn - dlt)) / (2 * eps)
        mask = np.abs(fd) > 1e-3
        if mask.any():
            np.testing.assert_allclose(g[mask], fd[mask], rtol=0.4, atol=3e-3)


# ---------------------------------------------------------------------------
# Part 2: the port's gradient vs jax.grad on the same inputs
# ---------------------------------------------------------------------------

def _all_lights_sphere():
    """tests/test_grad.py's sphere scene with every light type (point padded
    to 4, directional, spot, area), in the JAX package's types."""
    sphere = JMeshModel.from_fat(jmake_sphere(radius=1.0, lat=10, lon=12),
                                 base_color=(0.8, 0.3, 0.2), roughness=0.5)
    lights = JLightSet.make(
        point_pos=[[2, 3, 2]], point_color=[[15, 15, 15]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
        area_pos=[[0, 3, 1]], area_color=[[4, 4, 3]], area_u=[[0.5, 0, 0]],
        area_v=[[0, 0, 0.5]]).pad_points(4)
    scene, _ = jbuild_scene([sphere], [JInstance(0)], lights)
    return scene, JCamera.make(pos=(0, 0.5, 3.5), target=(0, 0, 0))


def _all_groups(jscene, jcam, instances) -> dict:
    """Every apply_params group at (or, for the materials, near) the
    scene's own values, as numpy."""
    a = lambda x: np.asarray(x, np.float32)
    return {"base_color": a(jscene.mat_base), "roughness": a(jscene.mat_rough),
            "metalness": a(jscene.mat_metal) + 0.1,
            "emissive": a(jscene.mat_emissive) + 0.1,
            "point_color": a(jscene.lights.point_color),
            "dir_color": a(jscene.lights.dir_color),
            "area_color": a(jscene.lights.area_color),
            "translation": np.zeros((len(instances), 3), np.float32),
            "instance_trs": {k: a(v) for k, v in
                             jgrad.trs_params_from_instances(instances).items()},
            "camera_pos": a(jcam.pos), "camera_target": a(jcam.target)}


def _both_grads(jscene, jcam, jcfg, p0, seed=0):
    """(jax.grad, the port's gradient) of the L2 loss against a seeded
    random target, as {path: array}, on the same scene and parameters."""
    n = jcfg.n_pixels
    target = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    jids = jnp.arange(n, dtype=jnp.int32)
    jloss = jgrad.make_loss_fn(jscene, jcam, jcfg, jnp.asarray(target), jids)
    jg = jax.grad(lambda p: jloss(p, jax.random.key(0), 0))(jax.tree.map(jnp.asarray, p0))
    params = tgrad.params_from_numpy(p0, device="cpu")
    tloss = tgrad.make_loss_fn(port_scene(jscene), port_camera(jcam), port_config(jcfg),
                               torch.from_numpy(target),
                               torch.arange(n, dtype=torch.int32))
    tloss(params, 0, 0).backward()
    want = {p: np.asarray(v) for p, v in tgrad.param_items(jax.tree.map(np.asarray, jg))}
    got = {p: v.grad.numpy() for p, v in tgrad.param_items(params) if v.requires_grad}
    return want, got


def _assert_group_matches(want, got, group):
    keys = [p for p in got if p[0] == group]
    assert keys, group
    for p in keys:
        assert np.isfinite(got[p]).all(), p
        np.testing.assert_allclose(got[p], want[p], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(p))
    assert any(np.abs(want[p]).max() > 0 for p in keys), f"{group}: jax.grad is 0"


@pytest.fixture(scope="module")
def sphere_grads():
    jscene, jcam = _all_lights_sphere()
    return _both_grads(jscene, jcam, JCFG, _all_groups(jscene, jcam, [JInstance(0)]))


GROUPS = ["base_color", "roughness", "metalness", "emissive", "point_color",
          "dir_color", "area_color", "translation", "instance_trs", "camera_pos",
          "camera_target"]


@pytest.mark.parametrize("group", GROUPS)
def test_grad_matches_jax(sphere_grads, group):
    """Every apply_params group on the sphere scene (CFG, f32 engine)."""
    _assert_group_matches(*sphere_grads, group)


@pytest.fixture(scope="module")
def instanced_grads():
    jscene, jcam = instanced_scene()
    _, instances, _, _ = instanced_parts()
    p0 = _all_groups(jscene, jcam, instances)
    p0 = {k: p0[k] for k in ("instance_trs", "point_color", "base_color")}
    return _both_grads(jscene, jcam, SLICE_CFG, p0)


@pytest.mark.parametrize("group", ["instance_trs", "point_color", "base_color"])
def test_instanced_grad_matches_jax(instanced_grads, group):
    """The two-level instanced scene, 2 bounces, AA, one shadow ray."""
    _assert_group_matches(*instanced_grads, group)


def test_bf16_engine_grad_matches_jax():
    """The default bf16 engine on the sphere scene: its hits (prim and the
    lanes it drops) decide the paths; the gradients are the JAX package's."""
    jscene, jcam = _all_lights_sphere()
    jcfg = JCFG.replace(leaf_precision="bf16")
    p0 = _all_groups(jscene, jcam, [JInstance(0)])
    p0 = {k: p0[k] for k in ("base_color", "roughness", "point_color", "camera_pos")}
    want, got = _both_grads(jscene, jcam, jcfg, p0)
    for group in p0:
        _assert_group_matches(want, got, group)


def test_apply_params_leaves_the_scene_unchanged(setup):
    """apply_params builds new containers; the caller's tensors keep their
    values through a forward and backward pass."""
    scene, cam, render_mean = setup
    before = {f.name: getattr(scene, f.name).clone() for f in dataclasses.fields(scene)
              if isinstance(getattr(scene, f.name), torch.Tensor)}
    cam_before = cam.pos.clone()
    trs = trs_params_from_instances([Instance(0)], device="cpu")
    params = tgrad.clone_params({"instance_trs": trs, "base_color": scene.mat_base,
                                 "point_color": scene.lights.point_color,
                                 "camera_pos": cam.pos})
    render_mean(params).backward()
    assert params["base_color"].grad is not None
    assert params["instance_trs"]["base_inv"].grad is None
    for k, v in before.items():
        assert torch.equal(getattr(scene, k), v), k
    assert torch.equal(cam.pos, cam_before)
    assert not scene.mat_base.requires_grad and not cam.pos.requires_grad


def test_sharded_loss_is_not_ported(setup):
    scene, cam, _ = setup
    with pytest.raises(NotImplementedError, match="item 9"):
        tgrad.make_loss_fn(scene, cam, CFG, None, IDS, axis_name="tiles")
    with pytest.raises(NotImplementedError, match="item 9"):
        make_train_step(scene, cam, CFG, None, axis_name="tiles")
    with pytest.raises(NotImplementedError, match="item 9"):
        make_sharded_train_step(None, scene, cam, CFG, None)


# ---------------------------------------------------------------------------
# Part 3: the traversal is detached for every engine
# ---------------------------------------------------------------------------

ENGINE_FNS = {
    "f32": (trace, ("sorted_closest_dense", "sorted_any_dense",
                    "intersect_closest_dense", "intersect_any_dense")),
    "bf16": (trace_bf16, ("sorted_closest_bf16", "sorted_any_bf16",
                          "intersect_closest_bf16", "intersect_any_bf16")),
    "pallas_rows": (trace_rows, ("sorted_rows_closest", "sorted_rows_any",
                                 "rows_closest_dense", "rows_any_dense")),
}


@pytest.mark.parametrize("engine", list(ENGINE_FNS))
def test_traversal_is_detached(setup, monkeypatch, engine):
    """On the CPU, the engine functions the integrator dispatches to see o,
    d and t_max with no autograd history, while the rays themselves (from
    camera_pos) and the loss's parameters carry one; the gradient still
    reaches every parameter through refine_hit and shading."""
    scene, cam, _ = setup
    module, names = ENGINE_FNS[engine]
    seen = []

    def spy(fn):
        def wrapped(dbvh, o, d, t_max=None, *a, **kw):
            seen.append(any(x is not None and x.requires_grad for x in (o, d, t_max)))
            return fn(dbvh, o, d, t_max, *a, **kw)
        return wrapped

    for name in names:
        monkeypatch.setattr(module, name, spy(getattr(module, name)))
    cfg = CFG.replace(bounces=2, one_shadow_ray=False)
    if engine == "pallas_rows":
        cfg = cfg.replace(traversal="pallas_rows")
    else:
        cfg = cfg.replace(leaf_precision=engine)
    params = tgrad.clone_params({"base_color": scene.mat_base,
                                 "point_color": scene.lights.point_color,
                                 "camera_pos": cam.pos})
    s, c = apply_params(scene, cam, params)
    torch.mean(render_color(s, c, cfg, 0, 0, IDS) ** 2).backward()
    assert len(seen) >= 3, seen         # 2 closest passes + occlusion passes
    assert not any(seen), f"{engine}: a traversal input carries autograd history"
    for k, v in params.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().max() > 0, k
