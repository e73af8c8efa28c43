"""Differentiable rendering entry points; counterpart of ``physically_based_ray_tracer_tpu/diff/grad.py``.

Detached sampling, as in the JAX package: hit *topology* (which prim,
which lobe, which light) carries no gradient. The integrator detaches the
rays at every traversal (``render/integrator.py::_closest`` / ``_anyhit``),
and (t, u, v), shading, NEE and accumulation are differentiable torch math
(``refine_hit`` re-intersects the hit triangle). Gradients come from
``torch.autograd``.

Supported parameter groups (``apply_params``):
    base_color  (M, 3)  per-model albedo        -> scene.mat_base
    roughness   (M,)    per-model roughness     -> scene.mat_rough
    metalness   (M,)    per-model metalness     -> scene.mat_metal
    emissive    (M, 3)  per-model emission      -> scene.mat_emissive
    point_color (NP, 3) point-light intensity   -> lights.point_color
    dir_color   (ND, 3)                          -> lights.dir_color
    area_color  (NA, 3)                          -> lights.area_color
    translation (Ninst, 3) per-instance offset  -> tri_v0 (BVH frozen)
    instance_trs {position (I,3), rotation (I,3) Euler radians,
        scale (I,3), base_inv (I,4,4) constant} -> the full re-bake of the
        world triangles and normals (build it with
        ``trs_params_from_instances``; BVH frozen)
    camera_pos  (3,), camera_target (3,)         -> the camera's look-at

The containers are frozen dataclasses of tensors: ``apply_params`` builds
new ones with ``dataclasses.replace`` and never writes the caller's
tensors. ``params_from_numpy`` and ``adam_state_from_optax`` carry a JAX
run's parameter dict and optax Adam state over, so it can resume here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.parallel.mesh import lookup
from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

# optax.adam's defaults (b1, b2, eps; eps_root = 0): its moments and bias
# correction are torch.optim.Adam's
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# the constant of the instance_trs group: carried, never optimised
CONSTANT_KEYS = ("base_inv",)


# ---------------------------------------------------------------------------
# Differentiable TRS: the GameObject::Synchronise composition T * R * S with
# the GLM Euler -> quaternion convention, as utils/math.compose_trs on the
# host, here in torch so that gradients flow
# ---------------------------------------------------------------------------

def quat_from_euler(euler: torch.Tensor) -> torch.Tensor:
    """(..., 3) Euler radians -> (..., 4) quaternion (x, y, z, w)."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(rx * 0.5), torch.sin(rx * 0.5)
    cy, sy = torch.cos(ry * 0.5), torch.sin(ry * 0.5)
    cz, sz = torch.cos(rz * 0.5), torch.sin(rz * 0.5)
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return torch.stack([x, y, z, w], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3) rotation."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def trs_matrix(position, rotation_euler, scale) -> torch.Tensor:
    """(..., 3) x 3 -> (..., 3, 4) affine T * R(quat-from-euler) * S."""
    lin = quat_to_matrix(quat_from_euler(rotation_euler)) * scale[..., None, :]
    return torch.cat([lin, position[..., :, None]], dim=-1)


def trs_params_from_instances(instances, device=DEFAULT_DEVICE) -> dict:
    """The ``instance_trs`` group of a list of scene Instances at their live
    TRS, plus the constant inverse of each baked base transform (inverted
    in float64, stored as float32). At these values the re-bake is the
    identity and its gradients are those of the reference's transform
    chain."""
    device = resolve(device)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    base = np.stack([np.asarray(i.transform, np.float64) for i in instances])
    return {"position": f32([i.position for i in instances]),
            "rotation": f32([i.rotation for i in instances]),
            "scale": f32([i.scale for i in instances]),
            "base_inv": f32(np.linalg.inv(base))}


def _normalized(x: torch.Tensor) -> torch.Tensor:
    """x / |x| through the rsqrt of the clamped square: a zero row (a
    degenerate pole triangle) keeps a finite zero gradient, where the
    gradient of ``linalg.norm`` at 0 is NaN."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True),
                                       min=1e-20))


def _rebake(s, g: dict) -> dict:
    """The world arrays under the delta transform A_i = M(pos, rot, scale)_i
    @ inv(M_base_i) of each instance (the identity at the initial TRS)."""
    m = trs_matrix(g["position"], g["rotation"], g["scale"])         # (I, 3, 4)
    base_inv = g["base_inv"].detach().to(torch.float32)               # (I, 4, 4)
    lin = torch.einsum("iab,ibc->iac", m[:, :, 0:3], base_inv[:, 0:3, 0:3])
    tcol = (torch.einsum("iab,ib->ia", m[:, :, 0:3], base_inv[:, 0:3, 3])
            + m[:, :, 3])
    inv_t = torch.linalg.inv(lin).transpose(1, 2)                     # normal matrix
    inst = s.prim_inst.long()
    lp, tp, np_ = lin[inst], tcol[inst], inv_t[inst]
    lc = inv_t[torch.repeat_interleave(inst, 3)]
    mm = lambda a, x: torch.einsum("pab,pb->pa", a, x)
    return dict(tri_v0=mm(lp, s.tri_v0) + tp, tri_e1=mm(lp, s.tri_e1),
                tri_e2=mm(lp, s.tri_e2), face_normal=_normalized(mm(np_, s.face_normal)),
                corner_normal=_normalized(mm(lc, s.corner_normal)))


def apply_params(scene, cam, params: dict):
    """Return (scene', cam') with the parameter groups of ``params`` in
    place of the scene's, camera's and lights' own values."""
    fields = {"base_color": "mat_base", "roughness": "mat_rough",
              "metalness": "mat_metal", "emissive": "mat_emissive"}
    s = dataclasses.replace(scene, **{f: params[k] for k, f in fields.items()
                                      if k in params})
    lights = {k: params[k] for k in ("point_color", "dir_color", "area_color")
              if k in params}
    if lights:
        s = dataclasses.replace(s, lights=dataclasses.replace(s.lights, **lights))
    if "translation" in params:
        # a per-instance world offset of v0 (e1, e2 and the normals do not
        # move); the BVH stays as built: hits come from the frozen tree,
        # shading from the moved triangles through refine_hit
        s = dataclasses.replace(
            s, tri_v0=s.tri_v0 + params["translation"][s.prim_inst.long()])
    if "instance_trs" in params:
        s = dataclasses.replace(s, **_rebake(s, params["instance_trs"]))
    if "camera_pos" in params:
        cam = dataclasses.replace(cam, pos=params["camera_pos"])
    if "camera_target" in params:
        cam = dataclasses.replace(cam, target=params["camera_target"])
    return s, cam


def render_color(scene, cam, cfg: RenderConfig, key: int, sample: int,
                 pixel_ids: torch.Tensor) -> torch.Tensor:
    """Raw linear radiance of a pixel batch (no film): the differentiable
    quantity."""
    color, _ = render_sample(scene, cam, cfg, key, sample, pixel_ids)
    return color


class _PMean(torch.autograd.Function):
    """``lax.pmean`` as ``jax.grad`` differentiates it inside ``shard_map``
    with ``check_vma=False``: the forward is the group's mean, and the
    backward all-reduces the cotangent (the transpose of ``psum`` there is
    ``psum``), divided by the size as well."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.pmean(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.pmean(g), None


def make_loss_fn(scene, cam, cfg: RenderConfig, target, pixel_ids,
                 axis_name: str | None = None):
    """loss_fn(params, key, sample): the L2 image loss over a pixel batch.

    With ``axis_name`` (a mesh registered under that name,
    ``parallel/mesh.py``; ``pixel_ids`` and ``target`` are this rank's
    block) the loss is averaged over the group, as the JAX package's is.
    Its gradient is then each rank's own block's, not the group's average:
    the loss's cotangent, 1 on every rank, is all-reduced and divided by the
    size, so each rank's loss term gets 1 (the JAX package's numbers under
    ``shard_map(check_vma=False)``; ROADMAP §C). ``diff/inverse.py``'s
    train step averages the gradients itself."""

    def loss_fn(params, key, sample):
        s, c = apply_params(scene, cam, params)
        color = render_color(s, c, cfg, key, sample, pixel_ids)
        loss = torch.mean((color - target) ** 2)
        if axis_name is not None:
            loss = _PMean.apply(loss, lookup(axis_name))
        return loss

    return loss_fn


def grad_check_fd(f, x, eps: float = 1e-3, atol: float = 1e-3, rtol: float = 0.15):
    """The autograd gradient of scalar ``f`` at tensor ``x`` against central
    finite differences (float64 steps, float32 evaluations). Returns
    (analytic, fd, ok_mask) as numpy arrays."""
    xg = x.detach().clone().requires_grad_(True)
    ga = torch.autograd.grad(f(xg), xg)[0].detach().cpu().numpy().astype(np.float64)
    xf = x.detach().cpu().numpy().astype(np.float64)
    fd = np.zeros_like(xf)
    at = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for i in range(xf.size):
            d = np.zeros_like(xf)
            d.flat[i] = eps
            fd.flat[i] = (float(f(at(xf + d))) - float(f(at(xf - d)))) / (2 * eps)
    return ga, fd, np.isclose(ga, fd, atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Parameters and optimiser state carried across from a JAX run
# ---------------------------------------------------------------------------

def param_items(params: dict, prefix: tuple = ()) -> list:
    """(path, leaf) of a (nested) parameter dict, keys sorted at every level
    (the order of ``jax.tree.leaves``)."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend(param_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def trainable(params: dict) -> list:
    """The leaves an optimiser updates, in ``param_items`` order: every
    leaf but the constants (``CONSTANT_KEYS``)."""
    return [v for path, v in param_items(params) if path[-1] not in CONSTANT_KEYS]


def adam(params: dict, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam over ``trainable(params)`` with optax.adam's
    defaults: the two take the same steps."""
    return torch.optim.Adam(trainable(params), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def map_params(params: dict, fn) -> dict:
    """The nested parameter dict with every leaf ``x`` under key ``k``
    replaced by ``fn(k, x)``."""
    return {k: map_params(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in params.items()}


def _leaf(k: str, t: torch.Tensor) -> torch.Tensor:
    return t if k in CONSTANT_KEYS else t.requires_grad_(True)


def params_from_numpy(params: dict, device=DEFAULT_DEVICE) -> dict:
    """A parameter dict of arrays (the JAX package's, as numpy; nested for
    ``instance_trs``) as fresh float32 leaf tensors on ``device``, each
    requiring a gradient but the constants."""
    device = resolve(device)
    return map_params(params, lambda k, x: _leaf(
        k, torch.tensor(np.asarray(x, np.float32), device=device)))


def clone_params(params: dict) -> dict:
    """Fresh leaf tensors with the values of ``params`` (a dict of tensors),
    each requiring a gradient but the constants."""
    return map_params(params, lambda k, x: _leaf(k, x.detach().clone()))


def _adam_moments(opt_state):
    """(count, mu, nu) of an optax Adam state: its ScaleByAdamState, a
    named tuple with those fields, anywhere in a chain's tuple (with its
    leaves as numpy arrays or JAX arrays)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(params: dict, opt_state, *, lr: float) -> dict:
    """The state dict of ``adam(params, lr)`` that continues an optax Adam
    run: its ``count`` becomes each parameter's ``step``, ``mu`` and ``nu``
    become ``exp_avg`` and ``exp_avg_sq``. Load it with
    ``optimizer.load_state_dict``. optax's state holds no learning rate,
    a torch state dict does: ``lr`` is the run's."""
    found = _adam_moments(opt_state)
    if found is None:
        raise ValueError("no Adam moments (count, mu, nu) in the optax state")
    count, mu, nu = found
    trained = lambda tree: [(p, x) for p, x in param_items(tree) if p[-1] not in CONSTANT_KEYS]
    paths = [p for p, _ in trained(params)]
    if [p for p, _ in trained(mu)] != paths or [p for p, _ in trained(nu)] != paths:
        raise ValueError("the optax state and the parameters differ in structure")
    like = lambda x, p: torch.tensor(np.asarray(x, np.float32),
                                     device=p.device).reshape(p.shape)
    state = {i: {"step": torch.tensor(float(np.asarray(count))),
                 "exp_avg": like(m, p), "exp_avg_sq": like(n, p)}
             for i, (p, (_, m), (_, n)) in enumerate(zip(trainable(params), trained(mu),
                                                         trained(nu)))}
    sd = adam(params, lr).state_dict()
    return {"state": state, "param_groups": sd["param_groups"]}
