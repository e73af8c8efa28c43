"""Inverse rendering: recover scene parameters from target images;
counterpart of ``physically_based_ray_tracer_tpu/diff/inverse.py``.

A train step renders a pixel batch at the current parameters, takes the L2
loss against the target, runs the backward pass and one Adam step
(``torch.optim.Adam`` with optax.adam's defaults, so a run carried over
from the JAX package takes the same steps). The optimiser owns the
parameters' state, as torch optimisers do, where optax threads it through
the step. The sharded step (pixels over a mesh, gradients averaged across
devices) waits for the port of ``parallel/``.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import (_SHARDED, adam,
                                                             apply_params,
                                                             clone_params,
                                                             render_color)


def make_train_step(scene, cam, cfg: RenderConfig, optimizer: torch.optim.Optimizer,
                    axis_name: str | None = None):
    """Returns step(params, key, sample, pixel_ids, target) -> loss: one
    Adam step of ``optimizer``, which was built over ``trainable(params)``
    (``diff.grad.adam``), in place. ``loss`` is the loss before the step,
    as a detached 0-d tensor."""
    if axis_name is not None:
        raise NotImplementedError(_SHARDED)

    def step(params, key, sample, pixel_ids, target):
        optimizer.zero_grad(set_to_none=True)
        s, c = apply_params(scene, cam, params)
        color = render_color(s, c, cfg, key, sample, pixel_ids)
        loss = torch.mean((color - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_sharded_train_step(mesh, scene, cam, cfg: RenderConfig, optimizer,
                            axis: str = "tiles"):
    """Pixels sharded over a mesh axis with the gradient averaged across it:
    not ported yet."""
    raise NotImplementedError(_SHARDED)


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
