"""Pinhole camera + Panini projection + equirect skydome sampling;
counterpart of ``physically_based_ray_tracer_tpu/scene/camera.py``.

The screen plane sits at distance 2 along ``ahead`` with half-extents
(aspect, 1); ``fov`` and ``distortion`` only drive the Panini projection
(``primary_rays(panini=True)``, taken when ``RenderConfig.post_processed``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.math import (constant, cross, length,
                                                              normalize)

PI = 3.141592653589


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters as tensors on one device."""

    pos: torch.Tensor          # (3,)
    target: torch.Tensor       # (3,)
    fov: torch.Tensor          # () degrees, Panini only
    distortion: torch.Tensor   # () Panini distortion parameter

    @staticmethod
    def make(pos, target, fov=40.0, distortion=40.0,
             device=DEFAULT_DEVICE) -> "Camera":
        device = resolve(device)
        f = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
        return Camera(f(pos), f(target), f(fov), f(distortion))

    def to(self, device) -> "Camera":
        return Camera(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class CameraBasis:
    ahead: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    top_left: torch.Tensor
    top_right: torch.Tensor
    bottom_left: torch.Tensor


def camera_basis(cam: Camera, aspect: float) -> CameraBasis:
    """Basis + screen-plane corners."""
    tmp_up = constant([0.0, 1.0, 0.0], cam.pos)
    ahead = normalize(cam.target - cam.pos)
    right = normalize(cross(ahead, tmp_up))
    up = normalize(cross(right, ahead))
    center = cam.pos + ahead * 2.0
    return CameraBasis(
        ahead=ahead, right=right, up=up,
        top_left=center - aspect * right + up,
        top_right=center + aspect * right + up,
        bottom_left=center - aspect * right - up)


def primary_rays(cam: Camera, xs: torch.Tensor, ys: torch.Tensor, width: int,
                 height: int, panini: bool = False):
    """Primary ray origins/directions for (fractional) pixel coords: u = x/W,
    v = y/H, the point lerped over the screen-plane corners; with
    ``panini=True`` the direction is re-projected through
    ``panini_projection`` (ndc = (2u - 1, 1 - 2v), ``cam.fov`` in degrees)."""
    basis = camera_basis(cam, aspect=width / height)
    u = xs * (1.0 / width)
    v = ys * (1.0 / height)
    p = (basis.top_left[None, :]
         + u[..., None] * (basis.top_right - basis.top_left)[None, :]
         + v[..., None] * (basis.bottom_left - basis.top_left)[None, :])
    d = normalize(p - cam.pos)
    if panini:
        ndc = torch.stack([2.0 * u - 1.0, 1.0 - 2.0 * v], dim=-1)
        pd = panini_projection(ndc, cam.fov * (PI / 180.0), cam.distortion)
        mag = length(p - cam.pos)
        world = (basis.right[None, :] * (pd[..., 0] * mag)[..., None]
                 + basis.up[None, :] * (pd[..., 1] * mag)[..., None]
                 + basis.ahead[None, :] * (pd[..., 2] * mag)[..., None])
        d = normalize(world)
    o = cam.pos.expand(d.shape)
    return o, d


def panini_projection(ndc: torch.Tensor, fov_rad, distortion) -> torch.Tensor:
    """Panini cylindrical-stereographic projection of (..., 2) ndc to unit
    (..., 3) camera-space directions (z ahead)."""
    fov_rad = torch.as_tensor(fov_rad, dtype=torch.float32, device=ndc.device)
    d = torch.as_tensor(distortion, dtype=torch.float32, device=ndc.device)
    fo = PI / 2 - fov_rad * 0.5
    f = torch.cos(fo) / torch.sin(fo) * 2.0
    f2 = f * f
    d2 = d * d
    b = ((torch.sqrt(torch.clamp((d + d2) * (d + d2) * (f2 + f2 * f2), min=0.0))
          - (d * f + f)) / (d2 + d2 * f2 - 1.0))
    h = ndc[..., 0] * b
    v = ndc[..., 1] * b
    h2 = h * h
    k = h2 / ((d + 1.0) * (d + 1.0))
    k2 = k * k
    discr = torch.clamp(k2 * d2 - (k + 1.0) * (k * d2 - 1.0), min=0.0)
    cos_phi = (-k * d + torch.sqrt(discr)) / (k + 1.0)
    s_big = (d + 1.0) / (d + cos_phi)
    tan_theta = v / s_big
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    sin_phi = torch.where(h < 0.0, -sin_phi, sin_phi)
    s = 1.0 / torch.sqrt(1.0 + tan_theta * tan_theta)
    return torch.stack([sin_phi * s, tan_theta * s, cos_phi * s], dim=-1)


def sample_skybox(sky: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Equirect HDR skydome, bilinear-filtered. sky: (H, W, 3) float32;
    d: (..., 3) unit directions. Texel indices wrap with a floor modulo (the
    JAX package's int32 ``%``, ``torch.remainder`` here) and the four taps
    are clamped gathers (``jnp.take(mode="clip")``)."""
    h, w = sky.shape[0], sky.shape[1]
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) / (2.0 * PI)
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    ut = u * w
    vt = v * h
    u0 = torch.remainder(torch.floor(ut).to(torch.int32), w)
    v0 = torch.remainder(torch.floor(vt).to(torch.int32), h)
    u1 = torch.remainder(u0 + 1, w)
    v1 = torch.remainder(v0 + 1, h)
    du = (ut - torch.floor(ut))[..., None]
    dv = (vt - torch.floor(vt))[..., None]
    flat = sky.reshape(-1, 3)
    take = lambda idx: flat[idx.long().clamp(0, flat.shape[0] - 1)]
    c00 = take(u0 + v0 * w)
    c01 = take(u1 + v0 * w)
    c10 = take(u0 + v1 * w)
    c11 = take(u1 + v1 * w)
    i0 = c00 + du * (c01 - c00)
    i1 = c10 + du * (c11 - c10)
    return i0 + dv * (i1 - i0)
