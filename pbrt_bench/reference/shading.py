"""Shading math of the renderer, frozen for the configurations the benchmark
runs: the default BRDF (GGX with Heitz VNDF sampling, the height-correlated
Lagarde G2 pre-divided by the specular denominator, Schlick Fresnel with the
shadowed F90, Lambert diffuse, combined through Fresnel) and the reference
quirk ``MIN_DIELECTRICS_F0 = 0.4``. Elementwise over leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.141592653589
TWO_PI = 2.0 * PI
ONE_OVER_PI = 1.0 / PI
MIN_DIELECTRICS_F0 = 0.4
EPSILON = 0.01
BVH_FAR = 1e30


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def dot3(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v, eps: float = 1e-20):
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=eps))
    return v * torch.where(n2 > 0, inv, torch.zeros_like(inv))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    if a.dtype == torch.float32:
        return torch.linalg.cross(a, b, dim=-1)
    # torch.linalg.cross takes no bfloat16 on the card: the same products
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def reflect(d, n):
    return d - 2.0 * dot3(d, n) * n


def refract(d, n, eta: float):
    cosi = torch.clamp(dot3(d, n), -1.0, 1.0)
    entering = cosi <= 0.0
    eta_ratio = torch.where(entering, torch.full_like(cosi, 1.0 / eta),
                            torch.full_like(cosi, eta))
    cos_theta = torch.abs(cosi)
    k = 1.0 - eta_ratio * eta_ratio * (1.0 - cos_theta * cos_theta)
    k_safe = torch.where(k > 0.0, k, torch.ones_like(k))
    refr = eta_ratio * (d - n * cos_theta) - n * torch.sqrt(k_safe)
    return torch.where(k <= 0.0, torch.zeros_like(d), refr)


def quat_rotation_to_z(v):
    q = torch.stack([v[..., 1], -v[..., 0], torch.zeros_like(v[..., 0]),
                     1.0 + v[..., 2]], dim=-1)
    qn = normalize(q)
    flip = v[..., 2:3] < -0.99999
    identity_flip = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=v.dtype,
                                 device=v.device).expand(qn.shape)
    return torch.where(flip, identity_flip, qn)


def quat_invert(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q, v):
    axis = q[..., :3]
    w = q[..., 3:4]
    return (2.0 * dot3(axis, v) * axis + (w * w - dot3(axis, axis)) * v
            + 2.0 * w * cross(axis, v))


def _vec3(x, like):
    return torch.tensor(x, dtype=like.dtype, device=like.device)


class Material(NamedTuple):
    base_color: torch.Tensor
    metalness: torch.Tensor
    emissive: torch.Tensor
    roughness: torch.Tensor
    transmissivness: torch.Tensor


def luminance(rgb):
    return dot(rgb, _vec3([0.2126, 0.7152, 0.0722], rgb))


def specular_f0(base_color, metalness):
    return lerp(torch.full_like(base_color, MIN_DIELECTRICS_F0), base_color,
                metalness[..., None])


def diffuse_reflectance(base_color, metalness):
    return base_color * (1.0 - metalness[..., None])


def fresnel_schlick(f0, f90, ndots):
    p = torch.pow(torch.clamp(1.0 - ndots, min=0.0), 5.0)
    return f0 + (f90[..., None] - f0) * p[..., None]


def shadowed_f90(f0):
    return torch.clamp((1.0 / MIN_DIELECTRICS_F0) * luminance(f0), max=1.0)


def smith_g1_ggx(alpha_squared, ndots_squared):
    return 2.0 / (torch.sqrt(((alpha_squared * (1.0 - ndots_squared)) + ndots_squared)
                             / torch.clamp(ndots_squared, min=1e-30)) + 1.0)


def g2_lagarde(alpha_squared, ndotl, ndotv):
    """Height-correlated Smith G2 over the specular denominator 4 NdotL NdotV."""
    a = ndotv * torch.sqrt(alpha_squared + ndotl * (ndotl - alpha_squared * ndotl))
    b = ndotl * torch.sqrt(alpha_squared + ndotv * (ndotv - alpha_squared * ndotv))
    return 0.5 / (a + b)


def g2_over_g1(alpha_squared, ndotl, ndotv):
    g1v = smith_g1_ggx(alpha_squared, ndotv * ndotv)
    g1l = smith_g1_ggx(alpha_squared, ndotl * ndotl)
    return g1l / (g1v + g1l - g1v * g1l)


def ggx_d(alpha_squared, ndoth):
    b = (alpha_squared - 1.0) * ndoth * ndoth + 1.0
    return alpha_squared / (PI * b * b)


def sample_hemisphere_cosine(u):
    a = torch.sqrt(torch.clamp(u[..., 0], min=1e-12))
    b = TWO_PI * u[..., 1]
    return torch.stack([a * torch.cos(b), a * torch.sin(b),
                        torch.sqrt(torch.clamp(1.0 - u[..., 0], min=1e-12))], dim=-1)


def sample_ggx_vndf(ve, alpha, u):
    """Visible-normal GGX sample (Heitz 2018), isotropic alpha."""
    vh = normalize(torch.stack([alpha * ve[..., 0], alpha * ve[..., 1], ve[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(lensq > 0.0, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30)),
                          torch.zeros_like(lensq))
    t1 = torch.where((lensq > 0.0)[..., None],
                     torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], dim=-1),
                     _vec3([1.0, 0.0, 0.0], ve).expand(vh.shape))
    t2 = cross(vh, t1)
    r = torch.sqrt(torch.clamp(u[..., 0], min=1e-12))
    phi = TWO_PI * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = lerp(torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)), p2, s)
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))[..., None] * vh)
    return normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=0.0)], dim=-1))


def eval_brdf(n, l, v, m: Material):
    """Direct-light BRDF times NdotL: (1 - F) * Lambert + GGX, zero if either
    direction is below the surface."""
    h = normalize(l + v)
    ndotl_raw = dot(n, l)
    ndotv_raw = dot(n, v)
    ndotl = torch.clamp(ndotl_raw, 0.00001, 1.0)
    ndotv = torch.clamp(ndotv_raw, 0.00001, 1.0)
    ldoth = saturate(dot(l, h))
    ndoth = saturate(dot(n, h))
    f0 = specular_f0(m.base_color, m.metalness)
    diff_refl = diffuse_reflectance(m.base_color, m.metalness)
    alpha = m.roughness * m.roughness
    alpha_sq = alpha * alpha
    f = fresnel_schlick(f0, shadowed_f90(f0), ldoth)
    d = ggx_d(torch.clamp(alpha_sq, min=0.00001), ndoth)
    g2 = g2_lagarde(alpha_sq, ndotl, ndotv)
    specular = f * (g2 * d * ndotl)[..., None]
    diffuse = diff_refl * (torch.ones_like(ndotl) * ONE_OVER_PI * ndotl)[..., None]
    combined = (1.0 - f) * diffuse + specular
    mask = (ndotv_raw <= 0.0) | (ndotl_raw <= 0.0)
    return torch.where(mask[..., None], torch.zeros_like(combined), combined)


def sample_brdf(u, shading_n, v, m: Material, specular_lobe):
    """Continuation ray of the picked lobe: (direction, weight, valid)."""
    q_rot = quat_rotation_to_z(shading_n)
    v_local = quat_rotate(q_rot, v)
    dir_diffuse = sample_hemisphere_cosine(u)
    f0 = specular_f0(m.base_color, m.metalness)
    alpha = m.roughness * m.roughness
    alpha_sq = alpha * alpha
    w_diffuse = (diffuse_reflectance(m.base_color, m.metalness)
                 * torch.ones_like(alpha)[..., None])
    h_spec = sample_ggx_vndf(v_local, alpha, u)
    vdoth = torch.clamp(dot(v_local, h_spec), 0.00001, 1.0)
    w_diffuse = w_diffuse * (1.0 - fresnel_schlick(f0, shadowed_f90(f0), vdoth))
    # specular lobe: mirror half vector at zero roughness
    h_mirror = _vec3([0.0, 0.0, 1.0], v_local).expand(h_spec.shape)
    h = torch.where((alpha == 0.0)[..., None], h_mirror, h_spec)
    dir_spec = 2.0 * dot(v_local, h)[..., None] * h - v_local
    hdotl = torch.clamp(dot(h, dir_spec), 0.00001, 1.0)
    ndotl = torch.clamp(dir_spec[..., 2], 0.00001, 1.0)
    ndotv = torch.clamp(v_local[..., 2], 0.00001, 1.0)
    w_spec = (fresnel_schlick(f0, shadowed_f90(f0), hdotl)
              * g2_over_g1(alpha_sq, ndotl, ndotv)[..., None])
    spec = specular_lobe[..., None]
    ray_local = torch.where(spec, dir_spec, dir_diffuse)
    weight = torch.where(spec, w_spec, w_diffuse)
    valid = luminance(weight) != 0.0
    return normalize(quat_rotate(quat_invert(q_rot), ray_local)), weight, valid


def specular_probability(m: Material, v, shading_n):
    """The specular-vs-diffuse lottery's probability, in [0.05, 0.7]."""
    f0 = luminance(specular_f0(m.base_color, m.metalness))
    diff_refl = luminance(diffuse_reflectance(m.base_color, m.metalness))
    fresnel_factor = torch.clamp(dot(v, shading_n), min=0.0)
    f0_rgb = torch.stack([f0, f0, f0], dim=-1)
    fres = saturate(luminance(fresnel_schlick(f0_rgb, shadowed_f90(f0_rgb), fresnel_factor)))
    adjusted = fres * 0.5
    p = adjusted / torch.clamp(adjusted + diff_refl * (1.0 - adjusted) * 1.5, min=0.0001)
    return torch.clamp(p, 0.05, 0.7)
