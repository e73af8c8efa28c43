"""Inverse rendering: recover scene parameters from target images;
counterpart of ``physically_based_ray_tracer_tpu/diff/inverse.py``.

A train step renders a pixel batch at the current parameters, takes the L2
loss against the target, runs the backward pass and one Adam step
(``torch.optim.Adam`` with optax.adam's defaults, so a run carried over
from the JAX package takes the same steps). The optimiser owns the
parameters' state, as torch optimisers do, where optax threads it through
the step. The sharded step shards the pixels over a mesh's ranks and
averages the gradients across them with one all_reduce before the step, so
every rank takes the same step.

On the card a step is recorded once as a CUDA graph (``StepGraph``) and
replayed for every later step of the same layout: the forward reads nothing
on the host (``render/integrator.py``), nor does the backward, and
``diff.grad.adam`` is ``capturable`` there, so the whole step runs without
Python dispatching its ~10^4 launches. The recorded body is the eager
step's own.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, apply_params,
                                                             clone_params, param_items,
                                                             render_color, trainable)
from physically_based_ray_tracer_tpu_torch.ops import take_rows
from physically_based_ray_tracer_tpu_torch.parallel.mesh import lookup
from physically_based_ray_tracer_tpu_torch.render.graph import RecordedLaunches, graph_path
from physically_based_ray_tracer_tpu_torch.utils import profiling, rng
from physically_based_ray_tracer_tpu_torch.utils.profiling import add_attrs, annotate


def _layout(params: dict, pixel_ids, target, optimizer) -> tuple:
    """What a recording fixes of a step's inputs: the parameters' leaves
    (by identity), the batch's shapes, dtypes and devices, and the
    optimiser's options (its learning rate is recorded as a constant)."""
    return (tuple(v for _, v in param_items(params)),
            tuple((tuple(x.shape), x.dtype, x.device) for x in (pixel_ids, target)),
            [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups])


def _same_layout(a: tuple, b: tuple) -> bool:
    return (len(a[0]) == len(b[0]) and all(x is y for x, y in zip(a[0], b[0]))
            and a[1:] == b[1:])


class StepGraph:
    """``body(params, seeds, 0, ids, target)``, one whole train step
    (``make_train_step``'s), recorded as one CUDA graph at construction and
    run by ``run`` for a step at ``key`` and ``sample``.

    What varies from step to step lives in device tensors at fixed
    addresses, which the recording reads: the batch's pixel ids and target
    rows, copied in before each replay; the step's stream seeds
    (``rng.SeedTable``), filled once a step by one copy from host memory;
    the parameters, the optimiser's leaves, which Adam updates in place.
    The gradients are allocated inside the recording (``body`` sets them to
    None first) and rewritten by each replay; ``run`` hands them back to
    the leaves, so that after a step the leaves hold its gradients, as
    after an eager step. The recording is made with the program's spans
    and counters paused; the launches it counts are credited at each
    replay (``RecordedLaunches``)."""

    def __init__(self, body, params: dict, pixel_ids, target, cfg: RenderConfig):
        self.leaves = trainable(params)
        self.ids = pixel_ids.clone()
        self.target = target.clone()
        # per bounce, at most every purpose as itself and as a uniform2 pair
        self.seeds = rng.SeedTable(max(1, cfg.bounces) * 3 * len(rng.Purpose),
                                   pixel_ids.device)
        self.graph = torch.cuda.CUDAGraph()
        with profiling.paused():
            self.launches = RecordedLaunches()
            with torch.cuda.graph(self.graph):
                self.loss = body(params, self.seeds, 0, self.ids, self.target)
            self.launches.take_back()
        self.grads = [v.grad for v in self.leaves]

    def run(self, key: int, sample: int, pixel_ids, target) -> torch.Tensor:
        """One step: the batch copied in, the seeds filled, one replay;
        returns a copy of the step's loss."""
        self.ids.copy_(pixel_ids)
        self.target.copy_(target)
        self.seeds.fill(key, sample)
        self.graph.replay()
        self.launches.credit()
        for v, g in zip(self.leaves, self.grads):
            v.grad = g
        return self.loss.clone()


def make_train_step(scene, cam, cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                    axis_name: str | None = None):
    """Returns step(params, key, sample, pixel_ids, target) -> loss: one
    Adam step of ``optimizer``, which was built over ``trainable(params)``
    (``diff.grad.adam``), in place. ``loss`` is the loss before the step,
    as a detached 0-d tensor.

    With ``axis_name`` (a mesh registered under that name,
    ``parallel/mesh.py``; ``pixel_ids`` and ``target`` are this rank's
    block): after the backward, every trainable leaf's gradient (zeros
    where it got none), in ``param_items`` order, goes into one flat
    all_reduce and is divided by the group's size (``lax.pmean`` of the
    gradients); the loss is averaged the same way. Every rank then takes
    the same Adam step.

    Where ``graph.graph_path`` allows the configuration on the batch's
    device (the card, the dense engines) and there is no ``axis_name``
    (the mesh's mean goes through host memory under gloo), steps replay a
    recording (``StepGraph``): the first such step runs eagerly on a side
    stream (the warm-up torch's capture needs; it creates Adam's state),
    the next of the same layout (``_layout``: the same leaves, batch shapes
    and optimiser options) records the step and replays the recording as
    its own, and every later one of that layout replays it. No step runs
    twice. A step of another layout runs eagerly, as every step does on
    the CPU. The values are the eager step's, bit for bit.

    A step is a ``pbrt.step`` span with the attributes ``replays`` (1 where
    the step replayed) and ``captures`` (1 where it recorded); an eager
    step has ``pbrt.forward`` (the parameters applied, the render and the
    loss) and ``pbrt.backward`` inside, and the backward's span counts the
    row gather's backward calls (``take_rows``) and the rows they reduced
    (``take_rows_rows``). A replayed step opens neither."""

    def body(params, key, sample, pixel_ids, target):
        optimizer.zero_grad(set_to_none=True)
        with annotate("pbrt.forward"):
            s, c = apply_params(scene, cam, params)
            color = render_color(s, c, cfg, key, sample, pixel_ids)
            loss = torch.mean((color - target) ** 2)
        with annotate("pbrt.backward"):
            calls, rows = take_rows.backward_calls()
            loss.backward()
            calls2, rows2 = take_rows.backward_calls()
            add_attrs(take_rows=calls2 - calls, take_rows_rows=rows2 - rows)
        loss = loss.detach()
        if axis_name is not None:
            mesh = lookup(axis_name)
            leaves = trainable(params)
            grads = [torch.zeros_like(v) if v.grad is None else v.grad for v in leaves]
            flat = mesh.pmean(torch.cat([g.reshape(-1) for g in grads]))
            for v, g in zip(leaves, flat.split([g.numel() for g in grads])):
                v.grad = g.view_as(v)
            loss = mesh.pmean(loss)
        optimizer.step()
        return loss

    held = {"layout": None, "graph": None}      # the warm-up's layout, the recording

    @annotate("pbrt.step")
    def step(params, key, sample, pixel_ids, target):
        device = pixel_ids.device
        if axis_name is not None or not graph_path(cfg, device):
            add_attrs(replays=0, captures=0)
            return body(params, key, sample, pixel_ids, target)
        layout = _layout(params, pixel_ids, target, optimizer)
        if held["layout"] is None:
            held["layout"] = layout
            main = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                loss = body(params, key, sample, pixel_ids, target)
            main.wait_stream(side)
            add_attrs(replays=0, captures=0)
            return loss
        if not _same_layout(layout, held["layout"]):
            add_attrs(replays=0, captures=0)
            return body(params, key, sample, pixel_ids, target)
        captures = 0
        if held["graph"] is None:
            held["graph"] = StepGraph(body, params, pixel_ids, target, cfg)
            captures = 1
        add_attrs(replays=1, captures=captures)
        return held["graph"].run(key, sample, pixel_ids, target)

    return step


def make_sharded_train_step(mesh, scene, cam, cfg: RenderConfig, optimizer,
                            axis: str = "tiles"):
    """The train step of one rank of ``mesh``: ``pixel_ids`` and ``target``
    are this rank's block (``parallel/shard.py::shard_rows``), the
    parameters and the optimiser replicated (the same values on every rank,
    e.g. through ``shard.replicate``); the gradients are averaged over the
    mesh (``make_train_step(axis_name=axis)``), so the ranks' parameters
    stay equal."""
    if axis != mesh.axis:
        raise ValueError(f"make_sharded_train_step(axis={axis!r}) on a mesh of axis "
                         f"{mesh.axis!r}")
    return make_train_step(scene, cam, cfg, optimizer, axis_name=axis)


def fit(scene, cam, cfg: RenderConfig, params0: dict, target, pixel_ids,
        steps: int = 100, lr: float = 5e-2, seed: int = 0, verbose: bool = False,
        vary_sample: bool = True):
    """Adam-optimise ``params0`` (a parameter dict of tensors, left as it
    is) to match ``target`` (B, 3) radiance; returns (params, losses).

    ``seed`` is the integer key of ``render_sample``. ``vary_sample=False``
    fixes the RNG streams to sample 0 every step (a target rendered at
    sample 0 can then be matched exactly); the default draws fresh sample
    decisions each step."""
    params = clone_params(params0)
    step = make_train_step(scene, cam, cfg, adam(params, lr))
    losses = []
    for i in range(steps):
        losses.append(float(step(params, seed, i if vary_sample else 0, pixel_ids, target)))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return params, losses
