"""Importance samplers; counterpart of ``physically_based_ray_tracer_tpu/ops/sampling.py``.

Elementwise over leading batch dims; random inputs ``u`` have trailing dim 2.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.utils.math import (constant, cross, lerp,
                                                              normalize)

PI = 3.141592653589
TWO_PI = 2.0 * PI
ONE_OVER_PI = 1.0 / PI


def sample_hemisphere_cosine(u: torch.Tensor):
    """Cosine-weighted hemisphere about +Z; returns (dir, pdf)."""
    a = torch.sqrt(torch.clamp(u[..., 0], min=1e-12))
    b = TWO_PI * u[..., 1]
    d = torch.stack([a * torch.cos(b), a * torch.sin(b),
                     torch.sqrt(torch.clamp(1.0 - u[..., 0], min=1e-12))], dim=-1)
    return d, d[..., 2] * ONE_OVER_PI


def sample_ggx_vndf_heitz(ve: torch.Tensor, alpha2d: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Visible-NDF GGX sample (Heitz 2018)."""
    ax = alpha2d[..., 0]
    ay = alpha2d[..., 1]
    vh = normalize(torch.stack([ax * ve[..., 0], ay * ve[..., 1], ve[..., 2]], dim=-1))

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(lensq > 0.0,
                          1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30)),
                          torch.zeros_like(lensq))
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        constant([1.0, 0.0, 0.0], ve).expand(vh.shape),
    )
    t2 = cross(vh, t1)

    r = torch.sqrt(torch.clamp(u[..., 0], min=1e-12))
    phi = TWO_PI * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = lerp(torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)), p2, s)

    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))[..., None] * vh)
    return normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)], dim=-1))


def sample_ggx_vndf_spherical_caps(ve: torch.Tensor, alpha2d: torch.Tensor,
                                   u: torch.Tensor) -> torch.Tensor:
    """VNDF via spherical caps (Dupuy & Benyoub 2023)."""
    ax = alpha2d[..., 0]
    ay = alpha2d[..., 1]
    vh = normalize(torch.stack([ax * ve[..., 0], ay * ve[..., 1], ve[..., 2]], dim=-1))
    phi = TWO_PI * u[..., 0]
    z = (1.0 - u[..., 1]) * (1.0 + vh[..., 2]) - vh[..., 2]
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, 1e-12, 1.0))
    nh = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), z],
                     dim=-1) + vh
    return normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)], dim=-1))


def sample_ggx_walter(vlocal: torch.Tensor, alpha2d: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Classic NDF sampling for GGX (Walter 2007)."""
    del vlocal
    alpha = 0.5 * (alpha2d[..., 0] + alpha2d[..., 1])
    a2 = alpha * alpha
    cos2 = (1.0 - u[..., 0]) / ((a2 - 1.0) * u[..., 0] + 1.0)
    cos_t = torch.sqrt(cos2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos2, min=1e-12))
    phi = TWO_PI * u[..., 1]
    return normalize(torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))


def sample_beckmann_walter(vlocal: torch.Tensor, alpha2d: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
    """Beckmann NDF sampling (Walter 2007 eq. 28/29)."""
    del vlocal
    alpha = 0.5 * (alpha2d[..., 0] + alpha2d[..., 1])
    tan2 = -(alpha * alpha) * torch.log(torch.clamp(1.0 - u[..., 0], min=1e-30))
    phi = TWO_PI * u[..., 1]
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    return normalize(torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))


def walters_trick(alpha, ndotv):
    """Roughness adjustment limiting Walter-sampling weight (~4)."""
    return (1.2 - 0.2 * torch.sqrt(torch.abs(ndotv))) * alpha
