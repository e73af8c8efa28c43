"""Pinhole camera; counterpart of ``physically_based_ray_tracer_tpu/scene/camera.py``.

The screen plane sits at distance 2 along ``ahead`` with half-extents
(aspect, 1). The Panini projection and the skydome sampler are off the
ported path (``post_processed`` and a real sky raise in the integrator).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.math import cross, normalize

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
    tmp_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                          device=cam.pos.device)
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
    """Primary ray origins/directions for (fractional) pixel coords."""
    if panini:
        raise NotImplementedError("primary_rays(panini=True): the Panini "
                                  "projection is not ported yet")
    basis = camera_basis(cam, aspect=width / height)
    u = xs * (1.0 / width)
    v = ys * (1.0 / height)
    p = (basis.top_left[None, :]
         + u[..., None] * (basis.top_right - basis.top_left)[None, :]
         + v[..., None] * (basis.bottom_left - basis.top_left)[None, :])
    d = normalize(p - cam.pos)
    o = cam.pos.expand(d.shape)
    return o, d
