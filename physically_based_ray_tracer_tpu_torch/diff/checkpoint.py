"""Checkpoint and resume of inverse-rendering optimisation state; counterpart
of ``physically_based_ray_tracer_tpu/diff/checkpoint.py``.

One ``torch.save`` file per checkpoint, ``{path}/step_{step}.pt``, holding
the parameters (detached), the optimiser's state dict and the step. The
JAX package writes orbax checkpoints (or ``.npz``) under the same
``step_{step}`` names.
"""

from __future__ import annotations

import os

import torch

from physically_based_ray_tracer_tpu_torch.diff.grad import map_params


def save_checkpoint(path: str, params: dict, opt_state, step: int) -> str:
    """Save (params, optimiser state, step) to ``path/step_{step}.pt``;
    ``opt_state`` is a ``torch.optim.Optimizer`` or its state dict. Returns
    the file's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if isinstance(opt_state, torch.optim.Optimizer):
        opt_state = opt_state.state_dict()
    out = os.path.join(path, f"step_{step}.pt")
    torch.save({"params": map_params(params, lambda k, x: x.detach().cpu()),
                "opt_state": opt_state, "step": int(step)}, out)
    return out


def load_checkpoint(path: str, like_params: dict, like_opt_state=None):
    """Restore (params, optimiser state dict, step) from a checkpoint file.
    The parameters come back as fresh leaf tensors on the devices of
    ``like_params``, each requiring a gradient where its counterpart there
    does; load the state into an optimiser over them with
    ``load_state_dict`` (it moves the state to the parameters' device).
    ``like_opt_state``, where given (an optimiser or its state dict), must
    hold as many parameter groups and parameters as the saved one."""
    data = torch.load(path, map_location="cpu", weights_only=True)

    def like(saved, ref):
        return {k: like(saved[k], v) if isinstance(v, dict) else
                saved[k].to(device=v.device, dtype=v.dtype).requires_grad_(v.requires_grad)
                for k, v in ref.items()}

    params = like(data["params"], like_params)
    opt_state = data["opt_state"]
    if like_opt_state is not None:
        if isinstance(like_opt_state, torch.optim.Optimizer):
            like_opt_state = like_opt_state.state_dict()
        shape = lambda sd: [len(g["params"]) for g in sd["param_groups"]]
        if shape(like_opt_state) != shape(opt_state):
            raise ValueError(f"checkpoint {path}: optimiser parameter groups "
                             f"{shape(opt_state)} differ from {shape(like_opt_state)}")
    return params, opt_state, int(data["step"])
