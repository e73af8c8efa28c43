"""Image-space post-processing; counterpart of ``physically_based_ray_tracer_tpu/ops/tonemap.py``.

Chromatic aberration, colour grading and vignette as one batched pass over
an (H, W, 3) float32 tensor, on the tensor's own device, in the reference's
order. ACES is the reference's commented-out alternative tonemap, provided
as an option.
"""

from __future__ import annotations

import torch


def chromatic_aberration(img: torch.Tensor, intensity: int) -> torch.Tensor:
    """Red/blue channel shift along x by ``intensity`` pixels (gathers
    clamped at the borders); the identity at 0."""
    if intensity == 0:
        return img
    w = img.shape[1]
    xs = torch.arange(w, device=img.device)
    x_r = torch.clamp(xs + intensity, 0, w - 1)
    x_b = torch.clamp(xs - intensity, 0, w - 1)
    r = 0.75 * img[:, :, 0] + 0.25 * img[:, x_r, 0]
    g = img[:, :, 1]
    b = 0.75 * img[:, :, 2] + 0.25 * img[:, x_b, 2]
    return torch.stack([r, g, b], dim=-1)


def vignette(img: torch.Tensor, intensity, radius) -> torch.Tensor:
    """uv*(1-uv) falloff vignette."""
    h, w = img.shape[0], img.shape[1]
    ux = (torch.arange(w, dtype=torch.float32, device=img.device) / w)[None, :]
    uy = (torch.arange(h, dtype=torch.float32, device=img.device) / h)[:, None]
    vig = (ux * (1.0 - ux)) * (uy * (1.0 - uy)) * intensity
    vig = torch.pow(torch.clamp(vig, min=0.0), radius)
    return img * vig[..., None]


def color_grade(img: torch.Tensor, grading) -> torch.Tensor:
    """Per-channel multiplier."""
    g = torch.as_tensor(grading, dtype=torch.float32, device=img.device)
    return img * g[None, None, :3]


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


# Named post-process presets of the reference's camera. Each entry:
# (grading rgb, fov deg, panini distortion, vignette intensity,
#  vignette radius, aberration px). Preset 2 is the engine's defaults.
POST_PRESETS = {
    1: {"grading": (1.0, 1.0, 1.2), "fov": 90.0, "distortion": 2.0,
        "vignette_intensity": 5.5, "vignette_radius": 0.8,
        "aberration_intensity": -1},
    2: {"grading": (1.0, 1.0, 1.0), "fov": 40.0, "distortion": 40.0,
        "vignette_intensity": 20.0, "vignette_radius": 0.3,
        "aberration_intensity": 0},
}


def post_process(img: torch.Tensor, aberration_intensity: int = 0,
                 vignette_intensity: float = 20.0, vignette_radius: float = 0.3,
                 grading=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Full reference chain: aberration -> grading -> vignette."""
    img = chromatic_aberration(img, aberration_intensity)
    img = color_grade(img, grading)
    img = vignette(img, vignette_intensity, vignette_radius)
    return img
