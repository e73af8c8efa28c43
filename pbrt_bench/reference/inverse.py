"""The reference inverse-rendering step: the parameter groups put into the
reference scene (materials, light colours, the TRS re-bake of every
instance, the camera), the L2 loss of a pixel batch against a target, its
gradient by autograd (the intersection carries none, as in the renderer:
hit topology is detached, (t, u, v) are recomputed on the hit triangle),
and Adam (betas 0.9 / 0.999, eps 1e-8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_bench.reference.geometry import RefScene, trs
from pbrt_bench.reference.integrator import render_sample

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def base_inverse(instances) -> np.ndarray:
    """(I, 4, 4) float32 inverses of the instances' baked transforms
    (inverted in float64)."""
    return np.stack([np.linalg.inv(trs(i["position"], i["rotation"], i["scale"])
                                   .astype(np.float64)) for i in instances]).astype(np.float32)


def _quat(e):
    rx, ry, rz = e[..., 0], e[..., 1], e[..., 2]
    cx, sx = torch.cos(rx * 0.5), torch.sin(rx * 0.5)
    cy, sy = torch.cos(ry * 0.5), torch.sin(ry * 0.5)
    cz, sz = torch.cos(rz * 0.5), torch.sin(rz * 0.5)
    return (sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz)


def _trs(position, rotation, scale):
    """(I, 3, 4) affine T * R * S, differentiable."""
    x, y, z, w = _quat(rotation)
    r = torch.stack([torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                                  2 * (x * z + w * y)], -1),
                     torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                                  2 * (y * z - w * x)], -1),
                     torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                                  1 - 2 * (x * x + y * y)], -1)], -2)
    return torch.cat([r * scale[..., None, :], position[..., :, None]], dim=-1)


def _unit(x):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=1e-20))


def apply(scene: RefScene, params: dict, base_inv: torch.Tensor) -> RefScene:
    """The scene with the parameter groups in place of its own values; the
    world arrays re-baked under A_i = M(pos, rot, scale)_i inv(M_base_i)."""
    mat = dict(scene.mat, base=params["base_color"], rough=params["roughness"],
               metal=params["metalness"], emissive=params["emissive"])
    lights = dict(scene.lights, point_color=params["point_color"],
                  dir_color=params["dir_color"])
    g = params["instance_trs"]
    m = _trs(g["position"], g["rotation"], g["scale"])
    lin = torch.einsum("iab,ibc->iac", m[:, :, 0:3], base_inv[:, 0:3, 0:3])
    tcol = torch.einsum("iab,ib->ia", m[:, :, 0:3], base_inv[:, 0:3, 3]) + m[:, :, 3]
    # torch.linalg.inv takes no bfloat16: inverted in float32, then rounded
    inv_t = torch.linalg.inv(lin.float()).to(lin.dtype).transpose(1, 2)
    inst = scene.prim_inst
    lp, tp, np_ = lin[inst], tcol[inst], inv_t[inst]
    mm = lambda a, x: torch.einsum("pab,pb->pa", a, x)
    cn = torch.einsum("pab,pcb->pca", np_, scene.corner_n)
    return dataclasses.replace(
        scene, v0=mm(lp, scene.v0) + tp, e1=mm(lp, scene.e1), e2=mm(lp, scene.e2),
        face_n=_unit(mm(np_, scene.face_n)), corner_n=_unit(cn), mat=mat, lights=lights,
        cam_pos=params["camera_pos"], cam_target=params["camera_target"])


def leaves(params: dict, prefix: str = "") -> list:
    """(name, tensor) of every trainable leaf, keys sorted at every level."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + k + "."))
        else:
            out.append((prefix + k, v))
    return out


def make_params(start: dict, device, dtype) -> dict:
    """Leaf tensors requiring gradients from a dict of numpy arrays."""
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=device,
                               dtype=dtype).requires_grad_(True)
    return {k: ({kk: f(vv) for kk, vv in v.items()} if isinstance(v, dict) else f(v))
            for k, v in start.items()}


def run_steps(scene: RefScene, start: dict, base_inv_np, batches, target, key: int,
              lr: float, width: int, height: int, bounces: int):
    """Adam steps from ``start`` over ``batches`` (pixel-id tensors, one per
    step, sample = step index). Returns (losses, first gradient per leaf,
    parameters before and after, per leaf)."""
    dev, dt = scene.v0.device, scene.dtype
    params = make_params(start, dev, dt)
    named = leaves(params)
    before = {n: v.detach().clone() for n, v in named}
    base_inv = torch.tensor(base_inv_np, device=dev, dtype=dt)
    opt = torch.optim.Adam([v for _, v in named], lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    losses, first_grad = [], None
    for k, ids in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        s = apply(scene, params, base_inv)
        color, _ = render_sample(s, ids, key, k, width, height, bounces)
        loss = torch.mean((color - target[ids].to(dt)) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {n: (torch.zeros_like(v) if v.grad is None else v.grad.detach().clone())
                          for n, v in named}
        opt.step()
    after = {n: v.detach().clone() for n, v in named}
    return losses, first_grad, before, after
