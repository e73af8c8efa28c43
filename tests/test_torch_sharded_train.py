"""The port's sharded train step (``diff/inverse.py::make_sharded_train_step``)
and sharded loss (``diff/grad.py::make_loss_fn(axis_name=...)``) on 2 gloo
ranks on the CPU, held to the JAX package's on 2 virtual devices.

The problem: ``sphere_scene`` at tests/test_torch_grad.py's JCFG (12x12, 1
bounce, no AA, the f32 engine), the albedo, roughness and point-light
colour groups, a zero target, Adam at lr 1e-2, key 0, sample 0; 72 pixels
a rank. Tolerances are tests/test_torch_grad.py's for port vs ``jax.grad``
(rtol 1e-3, atol 1e-6):

* one sharded step: the loss, the averaged gradients and the updated
  parameters equal the JAX step's (its gradients are the mean of the
  per-shard gradients below, which is what its ``pmean`` takes); both
  ranks' parameters are bit-equal after it;
* ``make_loss_fn(axis_name)``: each rank's gradient equals ``jax.grad``'s
  inside ``shard_map`` on the same device index, which is the shard's own
  gradient, not the mean (ROADMAP §C);
* tests/test_multiprocess.py's two-process training replayed on the port
  (``TINY``, two steps at samples 0 and 1): the ranks' losses agree within
  1e-6."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig as JRenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.diff import grad as jgrad  # noqa: E402
from physically_based_ray_tracer_tpu.diff.inverse import (  # noqa: E402
    make_sharded_train_step as jsharded_step)
from physically_based_ray_tracer_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel.mesh import spawn_ranks  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.scenes import TINY, sphere_scene  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
LR = 1e-2
JCFG = JRenderConfig(width=12, height=12, bounces=1, antialias=False, skybox=False,
                     max_stack_depth=24, gamma_corrected=False, leaf_precision="f32")
GROUPS = ("base_color", "point_color", "roughness")


def _jparams(scene):
    return {"base_color": scene.mat_base, "roughness": scene.mat_rough,
            "point_color": scene.lights.point_color}


@pytest.fixture(scope="module")
def setup():
    jscene, jcam = sphere_scene()
    n = JCFG.n_pixels
    jmesh = jmake_mesh(2)
    key = jax.random.key(0)
    ids = jnp.arange(n, dtype=jnp.int32)
    target = jnp.zeros((n, 3), jnp.float32)
    params = _jparams(jscene)
    opt = optax.adam(LR)
    jp1, _, jloss = jsharded_step(jmesh, jscene, jcam, JCFG, opt)(
        params, opt.init(params), key, 0, ids, target)

    def local(params, ids, tgt):
        loss_fn = jgrad.make_loss_fn(jscene, jcam, JCFG, tgt, ids, axis_name="tiles")
        loss, g = jax.value_and_grad(lambda p: loss_fn(p, key, 0))(params)
        return loss[None], jax.tree.map(lambda x: x[None], g)

    shard_loss, shard_grad = jax.jit(shard_map(
        local, mesh=jmesh, in_specs=(P(), P("tiles"), P("tiles")),
        out_specs=P("tiles"), check_vma=False))(params, ids, target)

    scene, cam = port_scene(jscene), port_camera(jcam)
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    out = spawn_ranks(torch_ranks.train, 2, timeout=300, args=(
        2, scene, cam, port_config(JCFG), p0, torch.zeros((n, 3)), 2, LR))
    want = dict(params=jax.tree.map(np.asarray, jp1), loss=float(jloss),
                shard_loss=np.asarray(shard_loss),
                shard_grad=jax.tree.map(np.asarray, shard_grad))
    return out, want


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_sharded_step_matches_jax(setup):
    out, want = setup
    for o in out:
        _close(o["losses"][0], want["loss"])
        for g in GROUPS:
            _close(o["grads"][g], want["shard_grad"][g].mean(axis=0))
            _close(o["first"][g], want["params"][g])
    assert np.abs(want["shard_grad"]["base_color"]).max() > 1e-4


def test_ranks_parameters_bit_equal_after_each_step(setup):
    out, _ = setup
    for g in GROUPS:
        np.testing.assert_array_equal(out[0]["first"][g], out[1]["first"][g])
        np.testing.assert_array_equal(out[0]["last"][g], out[1]["last"][g])
        np.testing.assert_array_equal(out[0]["grads"][g], out[1]["grads"][g])
    assert out[0]["losses"] == out[1]["losses"]


def test_sharded_loss_gradient_is_the_shards_own(setup):
    out, want = setup
    for r, o in enumerate(out):
        _close(o["loss_fn_value"], want["shard_loss"][r])
        for g in GROUPS:
            _close(o["loss_fn_grad"][g], want["shard_grad"][g][r])
    # the two shards' gradients differ: not averaged
    assert not np.allclose(want["shard_grad"]["base_color"][0],
                           want["shard_grad"]["base_color"][1])


def test_two_process_training_replayed():
    """tests/test_multiprocess.py's training on the port: TINY, zero target,
    two Adam steps (samples 0 and 1), the loss the same on both ranks."""
    jscene, jcam = sphere_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    n = TINY.n_pixels
    p0 = {k: torch.from_numpy(np.array(v)) for k, v in _jparams(jscene).items()}
    out = spawn_ranks(torch_ranks.train, 2, timeout=300, args=(
        2, scene, cam, port_config(TINY), p0, torch.zeros((n, 3)), 2, LR))
    losses = [o["losses"][-1] for o in out]
    assert all(np.isfinite(losses))
    assert abs(losses[0] - losses[1]) < 1e-6, losses
