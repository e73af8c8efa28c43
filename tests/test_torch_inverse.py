"""The port's inverse rendering (``diff/inverse.py``), its checkpoints
(``diff/checkpoint.py``) and the ``inverse_material`` entry, on the CPU.

Tolerances: the port's ``fit`` follows the JAX package's for 5 steps with
losses within 1e-3 relative (FIT_RTOL), and a run resumed from an optax
state carried over with ``adam_state_from_optax`` ends 3 steps later at
the JAX run's parameters within rtol 1e-4, atol 1e-6 (RESUME_RTOL,
RESUME_ATOL): the gradients agree to a few ulps (tests/test_torch_grad.py)
and Adam's step divides them by their own scale, so a step differs by
about that much of the learning rate. ``adam`` follows optax.adam for 10
steps of lr 0.05 on a quadratic within 1e-5 absolute (ADAM_ATOL, 2e-4 of a
step): torch computes the bias correction in float64 Python scalars and
divides by its root, optax computes it in float32 inside the root, and
near the optimum, where m / sqrt(v) is sensitive, that moves a step by a
few 1e-6. A checkpoint resume on the CPU repeats the uninterrupted run's
losses bit for bit. The step the card records (``diff/inverse.py``'s
``StepGraph``) reads nothing on the host after one step: its forward,
backward and capturable Adam update, run here with the recording's seed
table; its replays against eager steps: tests/test_torch_graph.py on the
card."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import importlib  # noqa: E402

import torch  # noqa: E402

from physically_based_ray_tracer_tpu.config import RenderConfig as JRenderConfig  # noqa: E402
from physically_based_ray_tracer_tpu.diff import grad as jgrad  # noqa: E402
from physically_based_ray_tracer_tpu.diff import inverse as jinverse  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu.scene.lights import LightSet as JLightSet  # noqa: E402
from physically_based_ray_tracer_tpu.scene.procedural import make_sphere  # noqa: E402
from physically_based_ray_tracer_tpu.scene.scene import Instance, MeshModel, build_scene  # noqa: E402
from physically_based_ray_tracer_tpu_torch import inverse_material  # noqa: E402
from physically_based_ray_tracer_tpu_torch.diff.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from physically_based_ray_tracer_tpu_torch.diff.grad import (  # noqa: E402
    ADAM_BETAS, ADAM_EPS, adam, adam_state_from_optax, clone_params, param_items,
    params_from_numpy, trainable)
from physically_based_ray_tracer_tpu_torch.diff.inverse import fit, make_train_step  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import take_rows  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import profiling, rng  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402
from tests.torch_step import (HostReads, bench_step_problem,  # noqa: E402
                              unwatch_plain_engines)

FIT_RTOL = 1e-3
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-6
ADAM_ATOL = 1e-5
LR = 0.02
JCFG = JRenderConfig(width=12, height=12, bounces=1, antialias=False,
                     skybox=False, max_stack_depth=24, gamma_corrected=False,
                     leaf_precision="f32")
CFG = port_config(JCFG)


@pytest.fixture(scope="module")
def problem():
    """tests/test_grad.py's sphere scene in both packages, the JAX target
    (sample 0, key 0) and a perturbed start of three groups, as numpy."""
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=10, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5)
    lights = JLightSet.make(point_pos=[[2, 3, 2]], point_color=[[15, 15, 15]]).pad_points(4)
    jscene, _ = build_scene([sphere], [Instance(0)], lights)
    jcam = JCamera.make(pos=(0, 0.5, 3.5), target=(0, 0, 0))
    jids = jnp.arange(JCFG.n_pixels, dtype=jnp.int32)
    target = np.array(jgrad.render_color(jscene, jcam, JCFG, jax.random.key(0), 0, jids))
    p0 = {"base_color": np.asarray(jscene.mat_base) * 0.4 + 0.3,
          "roughness": np.asarray(jscene.mat_rough) + 0.1,
          "point_color": np.asarray(jscene.lights.point_color) * 0.8}
    return dict(jscene=jscene, jcam=jcam, jids=jids, target=target, p0=p0,
                scene=port_scene(jscene), cam=port_camera(jcam),
                ids=torch.arange(JCFG.n_pixels, dtype=torch.int32))


def test_fit_follows_jax_fit(problem):
    """5 steps of fit with vary_sample=False from the same start."""
    pr = problem
    _, jlosses = jinverse.fit(pr["jscene"], pr["jcam"], JCFG,
                              jax.tree.map(jnp.asarray, pr["p0"]),
                              jnp.asarray(pr["target"]), pr["jids"], steps=5, lr=LR,
                              vary_sample=False)
    p0 = params_from_numpy(pr["p0"], device="cpu")
    params, losses = fit(pr["scene"], pr["cam"], CFG, p0, torch.from_numpy(pr["target"]),
                         pr["ids"], steps=5, lr=LR, vary_sample=False)
    np.testing.assert_allclose(losses, jlosses, rtol=FIT_RTOL)
    assert losses[-1] < losses[0]
    # fit leaves its start as it was
    for (_, a), b in zip(param_items(p0), param_items(pr["p0"])):
        np.testing.assert_array_equal(a.detach().numpy(), b[1])


def test_resume_from_optax_state(problem):
    """3 JAX steps, then the params and optax state carried over: 3 more
    steps on each side end at the same parameters."""
    pr = problem
    opt = optax.adam(LR)
    jstep = jax.jit(jinverse.make_train_step(pr["jscene"], pr["jcam"], JCFG, opt))
    jp = jax.tree.map(jnp.asarray, pr["p0"])
    js = opt.init(jp)
    jt = jnp.asarray(pr["target"])
    key = jax.random.key(0)
    for _ in range(3):
        jp, js, _ = jstep(jp, js, key, 0, pr["jids"], jt)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    optimizer = adam(params, LR)
    optimizer.load_state_dict(adam_state_from_optax(params, jax.tree.map(np.asarray, js),
                                                    lr=LR))
    assert float(optimizer.state_dict()["state"][0]["step"]) == 3
    jlosses = []
    for _ in range(3):
        jp, js, loss = jstep(jp, js, key, 0, pr["jids"], jt)
        jlosses.append(float(loss))
    step = make_train_step(pr["scene"], pr["cam"], CFG, optimizer)
    losses = [float(step(params, 0, 0, pr["ids"], torch.from_numpy(pr["target"])))
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=FIT_RTOL)
    for (path, a), (_, b) in zip(param_items(params),
                                 param_items(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL, err_msg=str(path))


def test_adam_matches_optax():
    """diff.grad.adam (torch.optim.Adam, optax's defaults) takes optax.adam's
    steps: the same moments and bias correction, eps after the root."""
    rng = np.random.default_rng(0)
    x0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    w = {k: rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32) for k, v in x0.items()}
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    jloss = lambda p: sum(jnp.sum(w[k] * (p[k] - 0.3) ** 2) for k in p)
    tloss = lambda p: sum(torch.sum(wt[k] * (p[k] - 0.3) ** 2) for k in p)
    opt = optax.adam(0.05)
    jp = jax.tree.map(jnp.asarray, x0)
    js = opt.init(jp)
    tp = params_from_numpy(x0, device="cpu")
    topt = adam(tp, 0.05)
    for _ in range(10):
        g = jax.grad(jloss)(jp)
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        topt.zero_grad()
        tloss(tp).backward()
        topt.step()
    for k in x0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint.py on the port: params, optimiser state, step."""
    params = clone_params({"base_color": torch.tensor([[0.1, 0.2, 0.3]]),
                           "roughness": torch.tensor([0.5])})
    opt = adam(params, 1e-2)
    (params["base_color"].sum() * 2 + params["roughness"].sum()).backward()
    opt.step()
    path = save_checkpoint(str(tmp_path / "ckpt"), params, opt, step=7)
    assert path == str(tmp_path / "ckpt" / "step_7.pt")
    p2, os2, step = load_checkpoint(path, params, opt)
    assert step == 7
    np.testing.assert_array_equal(p2["base_color"].detach().numpy(),
                                  params["base_color"].detach().numpy())
    assert p2["base_color"].requires_grad and p2["base_color"] is not params["base_color"]
    sd = opt.state_dict()
    assert os2["param_groups"] == sd["param_groups"]
    for i, st in sd["state"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(np.asarray(os2["state"][i][k]), np.asarray(v))


def test_checkpoint_resume_repeats_the_losses(problem, tmp_path):
    """Save after 3 steps, load into fresh parameters and a fresh optimiser,
    run 3 more: the losses are the uninterrupted run's, bit for bit."""
    pr = problem
    target = torch.from_numpy(pr["target"])

    def run(params, optimizer, n):
        step = make_train_step(pr["scene"], pr["cam"], CFG, optimizer)
        return [float(step(params, 0, 0, pr["ids"], target)) for _ in range(n)]

    params = params_from_numpy(pr["p0"], device="cpu")
    opt = adam(params, LR)
    straight = run(params, opt, 6)
    params = params_from_numpy(pr["p0"], device="cpu")
    opt = adam(params, LR)
    first = run(params, opt, 3)
    path = save_checkpoint(str(tmp_path), params, opt, step=3)
    fresh = params_from_numpy(pr["p0"], device="cpu")
    loaded, state, step = load_checkpoint(path, fresh, adam(fresh, LR))
    opt2 = adam(loaded, LR)
    opt2.load_state_dict(state)
    assert step == 3
    assert first + run(loaded, opt2, 3) == straight


def test_inverse_material_entry(capsys):
    """The entry runs on the CPU when asked and prints the example's lines."""
    assert inverse_material.main(["--device", "cpu", "--size", "12", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "loss: " in out
    assert "recovered albedo (model 0):" in out and "recovered roughness:" in out


def test_recorded_step_reads_nothing_on_the_host(monkeypatch):
    """After one step of the bench problem (every group the inverse cell
    fits, instance_trs included), a second step run as the card records it
    (the step's seeds from a ``rng.SeedTable``, Adam ``capturable``, here
    let onto the CPU) makes no host read and no upload: its forward, its
    backward (the row gathers' included) and the Adam update of every
    leaf, outside the engines' plain versions, which the card replaces by
its kernels. ``adam`` is capturable on CUDA leaves only."""
    cpu = torch.device("cpu")
    scene, cam, cfg, target, start = bench_step_problem(cpu, 16, 9)
    assert not adam(start, LR).defaults["capturable"]
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices", lambda: ["cpu"])
    params = clone_params(start)
    opt = torch.optim.Adam(trainable(params), lr=LR, betas=ADAM_BETAS, eps=ADAM_EPS,
                           capturable=True)
    step = make_train_step(scene, cam, cfg, opt)
    ids = torch.arange(0, cfg.n_pixels, 2, dtype=torch.int32)
    step(params, 7, 0, ids, target[ids.long()])
    seeds = rng.SeedTable(cfg.bounces * 3 * len(rng.Purpose), cpu)
    before = [v.detach().clone() for v in trainable(params)]
    calls = take_rows.backward_calls()[0]
    unwatch_plain_engines(monkeypatch)
    profiling.reset()
    mode = HostReads()
    with mode:
        step(params, seeds, 0, ids, target[ids.long()])
    assert mode.seen == [] and profiling.READS == {}
    assert take_rows.backward_calls()[0] - calls == 9          # the backward's gathers
    assert {"linalg_inv_ex", "addcdiv_"} <= mode.names         # the re-bake, Adam
    assert all(v.grad is not None and not torch.equal(v.detach(), b)
               for v, b in zip(trainable(params), before))
