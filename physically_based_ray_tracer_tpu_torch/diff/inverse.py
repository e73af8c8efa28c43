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
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, apply_params,
                                                             clone_params, render_color,
                                                             trainable)
from physically_based_ray_tracer_tpu_torch.parallel.mesh import lookup
from physically_based_ray_tracer_tpu_torch.utils.profiling import annotate


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

    A step is a ``pbrt.step`` span, with ``pbrt.forward`` (the parameters
    applied, the render and the loss) and ``pbrt.backward`` inside."""

    @annotate("pbrt.step")
    def step(params, key, sample, pixel_ids, target):
        optimizer.zero_grad(set_to_none=True)
        with annotate("pbrt.forward"):
            s, c = apply_params(scene, cam, params)
            color = render_color(s, c, cfg, key, sample, pixel_ids)
            loss = torch.mean((color - target) ** 2)
        with annotate("pbrt.backward"):
            loss.backward()
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
