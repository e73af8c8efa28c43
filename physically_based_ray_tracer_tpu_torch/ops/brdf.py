"""Microfacet BRDF stack; counterpart of ``physically_based_ray_tracer_tpu/ops/brdf.py``.

Every ``BRDFConfig`` branch of the JAX package is ported (the NDF, G2,
sampling and diffuse selectors are elementwise). The reference's quirks are
kept: ``MIN_DIELECTRICS_F0 = 0.4``, the shadowed F90 divided by it, and the
default GGX + height-correlated Lagarde G2 pre-divided by the specular
denominator + Schlick Fresnel + Lambert diffuse + Heitz VNDF sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physically_based_ray_tracer_tpu_torch.config import (
    MIN_DIELECTRICS_F0, NDF, BRDFConfig, DiffuseModel, SpecularModel)
from physically_based_ray_tracer_tpu_torch.ops import sampling
from physically_based_ray_tracer_tpu_torch.utils.math import (
    constant, dot, lerp, normalize, quat_invert, quat_rotate, quat_rotation_to_z,
    saturate)

PI = sampling.PI
ONE_OVER_PI = sampling.ONE_OVER_PI

DIFFUSE_TYPE = 1
SPECULAR_TYPE = 2


class MaterialProperties(NamedTuple):
    base_color: torch.Tensor      # (..., 3)
    metalness: torch.Tensor       # (...)
    emissive: torch.Tensor        # (..., 3)
    roughness: torch.Tensor       # (...)
    transmissivness: torch.Tensor  # (...)
    reflectance: torch.Tensor     # (...)
    opacity: torch.Tensor         # (...)


class BrdfData(NamedTuple):
    specular_f0: torch.Tensor
    diffuse_reflectance: torch.Tensor
    roughness: torch.Tensor
    alpha: torch.Tensor
    alpha_squared: torch.Tensor
    f: torch.Tensor
    v: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    l: torch.Tensor
    ndotl: torch.Tensor
    ndotv: torch.Tensor
    ldoth: torch.Tensor
    ndoth: torch.Tensor
    vdoth: torch.Tensor
    v_backfacing: torch.Tensor
    l_backfacing: torch.Tensor


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance."""
    return dot(rgb, constant([0.2126, 0.7152, 0.0722], rgb))


def base_color_to_specular_f0(base_color, metalness, reflectance=0.5,
                              cfg: BRDFConfig = BRDFConfig()):
    """lerp(minF0, baseColor, metalness)."""
    if cfg.use_reflectance_parameter:
        min_f0 = 0.16 * reflectance * reflectance
        min_f0 = min_f0[..., None].expand(base_color.shape)
    else:
        min_f0 = torch.full_like(base_color, MIN_DIELECTRICS_F0)
    return lerp(min_f0, base_color, metalness[..., None])


def base_color_to_diffuse_reflectance(base_color, metalness):
    return base_color * (1.0 - metalness[..., None])


def eval_fresnel_schlick(f0, f90, ndots):
    p = torch.pow(torch.clamp(1.0 - ndots, min=0.0), 5.0)
    return f0 + (f90[..., None] - f0) * p[..., None]


def shadowed_f90(f0):
    return torch.clamp((1.0 / MIN_DIELECTRICS_F0) * luminance(f0), max=1.0)


def smith_g_a(alpha, ndots):
    return ndots / (torch.clamp(alpha, min=0.00001)
                    * torch.sqrt(1.0 - torch.clamp(ndots * ndots, max=0.99999)))


def smith_g_lambda_ggx(a):
    return (-1.0 + torch.sqrt(1.0 + 1.0 / (a * a))) * 0.5


def smith_g_lambda_beckmann_walter(a):
    return torch.where(
        a < 1.6,
        (1.0 - (1.259 - 0.396 * a) * a) / ((3.535 + 2.181 * a) * a),
        torch.zeros_like(a))


def smith_g1_ggx(alpha_squared, ndots_squared):
    return 2.0 / (torch.sqrt(((alpha_squared * (1.0 - ndots_squared)) + ndots_squared)
                             / torch.clamp(ndots_squared, min=1e-30)) + 1.0)


def smith_g2_height_correlated(alpha, ndotl, ndotv, ndf: NDF = NDF.GGX):
    lam = smith_g_lambda_ggx if ndf == NDF.GGX else smith_g_lambda_beckmann_walter
    al = smith_g_a(alpha, ndotl)
    av = smith_g_a(alpha, ndotv)
    return 1.0 / (1.0 + lam(al) + lam(av))


def smith_g2_separable_ggx_lagarde(alpha_squared, ndotl, ndotv):
    a = ndotv + torch.sqrt(alpha_squared + ndotv * (ndotv - alpha_squared * ndotv))
    b = ndotl + torch.sqrt(alpha_squared + ndotl * (ndotl - alpha_squared * ndotl))
    return 1.0 / (a * b)


def smith_g2_height_correlated_ggx_lagarde(alpha_squared, ndotl, ndotv):
    a = ndotv * torch.sqrt(alpha_squared + ndotl * (ndotl - alpha_squared * ndotl))
    b = ndotl * torch.sqrt(alpha_squared + ndotv * (ndotv - alpha_squared * ndotv))
    return 0.5 / (a + b)


def smith_g2_over_g1_height_correlated(alpha, alpha_squared, ndotl, ndotv):
    del alpha
    g1v = smith_g1_ggx(alpha_squared, ndotv * ndotv)
    g1l = smith_g1_ggx(alpha_squared, ndotl * ndotl)
    return g1l / (g1v + g1l - g1v * g1l)


def smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg: BRDFConfig = BRDFConfig()):
    """With the default config the value is G2 / (4 NdotL NdotV)."""
    if cfg.use_optimized_g2 and cfg.ndf == NDF.GGX:
        if cfg.use_height_correlated_g2:
            return smith_g2_height_correlated_ggx_lagarde(alpha_squared, ndotl, ndotv)
        return smith_g2_separable_ggx_lagarde(alpha_squared, ndotl, ndotv)
    if cfg.use_height_correlated_g2:
        return smith_g2_height_correlated(alpha, ndotl, ndotv, cfg.ndf)
    raise NotImplementedError("separable non-optimized G2 (reference lacks it too)")


def g2_divided_by_denominator(cfg: BRDFConfig = BRDFConfig()) -> bool:
    return cfg.use_optimized_g2 and cfg.ndf == NDF.GGX


def ggx_d(alpha_squared, ndoth):
    b = (alpha_squared - 1.0) * ndoth * ndoth + 1.0
    return alpha_squared / (PI * b * b)


def beckmann_d(alpha_squared, ndoth):
    cos2 = ndoth * ndoth
    return torch.exp((cos2 - 1.0) / (alpha_squared * cos2)) / (PI * alpha_squared * cos2 * cos2)


def microfacet_d(alpha_squared, ndoth, cfg: BRDFConfig = BRDFConfig()):
    return (ggx_d if cfg.ndf == NDF.GGX else beckmann_d)(alpha_squared, ndoth)


def specular_sample_weight_ggx_vndf(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                    cfg: BRDFConfig = BRDFConfig()):
    del hdotl, ndoth
    if cfg.use_height_correlated_g2:
        return smith_g2_over_g1_height_correlated(alpha, alpha_squared, ndotl, ndotv)
    return smith_g1_ggx(alpha_squared, ndotl * ndotl)


def specular_sample_weight_ggx_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                      cfg: BRDFConfig = BRDFConfig()):
    if cfg.use_optimized_g2:
        return (ndotl * hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg) * 4.0) / ndoth
    return (hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg)) / (ndotv * ndoth)


def specular_sample_weight_beckmann_walter(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth,
                                           cfg: BRDFConfig = BRDFConfig()):
    return (hdotl * smith_g2(alpha, alpha_squared, ndotl, ndotv, cfg)) / (ndotv * ndoth)


def _sample_half_vector(vlocal, alpha2d, u, cfg: BRDFConfig):
    if cfg.ndf == NDF.BECKMANN:
        return sampling.sample_beckmann_walter(vlocal, alpha2d, u)
    if not cfg.use_vndf_sampling:
        return sampling.sample_ggx_walter(vlocal, alpha2d, u)
    if cfg.use_spherical_caps_vndf:
        return sampling.sample_ggx_vndf_spherical_caps(vlocal, alpha2d, u)
    return sampling.sample_ggx_vndf_heitz(vlocal, alpha2d, u)


def _specular_sample_weight(alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg):
    if cfg.ndf == NDF.BECKMANN:
        return specular_sample_weight_beckmann_walter(
            alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)
    if cfg.use_vndf_sampling:
        return specular_sample_weight_ggx_vndf(
            alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)
    return specular_sample_weight_ggx_walter(
        alpha, alpha_squared, ndotl, ndotv, hdotl, ndoth, cfg)


def sample_specular_microfacet(vlocal, alpha, alpha_squared, specular_f0, u,
                               cfg: BRDFConfig = BRDFConfig()):
    """Sample a reflection direction + weight in local space; returns
    (l_local, weight). Zero roughness yields the mirror direction."""
    alpha2d = torch.stack([alpha, alpha], dim=-1)
    h_rough = _sample_half_vector(vlocal, alpha2d, u, cfg)
    h_mirror = constant([0.0, 0.0, 1.0], vlocal).expand(h_rough.shape)
    h = torch.where((alpha == 0.0)[..., None], h_mirror, h_rough)
    l = 2.0 * dot(vlocal, h)[..., None] * h - vlocal
    hdotl = torch.clamp(dot(h, l), 0.00001, 1.0)
    ndotl = torch.clamp(l[..., 2], 0.00001, 1.0)
    ndotv = torch.clamp(vlocal[..., 2], 0.00001, 1.0)
    ndoth = torch.clamp(h[..., 2], 0.00001, 1.0)
    f = eval_fresnel_schlick(specular_f0, shadowed_f90(specular_f0), hdotl)
    weight = f * _specular_sample_weight(alpha, alpha_squared, ndotl, ndotv,
                                         hdotl, ndoth, cfg)[..., None]
    return l, weight


def diffuse_term(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    """Diffuse reflectance scale, pre-divided by the cosine-hemisphere pdf."""
    if cfg.diffuse == DiffuseModel.NONE:
        return torch.zeros_like(data.ndotl)
    if cfg.diffuse == DiffuseModel.LAMBERTIAN:
        return torch.ones_like(data.ndotl)
    if cfg.diffuse == DiffuseModel.OREN_NAYAR:
        sigma2 = data.alpha * data.alpha
        a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
        b = 0.45 * sigma2 / (sigma2 + 0.09)
        sin_v = torch.sqrt(torch.clamp(1.0 - data.ndotv * data.ndotv, min=0.0))
        sin_l = torch.sqrt(torch.clamp(1.0 - data.ndotl * data.ndotl, min=0.0))
        tv = normalize(data.v - data.ndotv[..., None] * data.n)
        tl = normalize(data.l - data.ndotl[..., None] * data.n)
        cos_dphi = torch.clamp(dot(tv, tl), min=0.0)
        sin_alpha = torch.maximum(sin_v, sin_l)
        tan_beta = torch.minimum(sin_v / torch.clamp(data.ndotv, min=1e-4),
                                 sin_l / torch.clamp(data.ndotl, min=1e-4))
        return a + b * cos_dphi * sin_alpha * tan_beta
    if cfg.diffuse == DiffuseModel.DISNEY:
        fd90 = 0.5 + 2.0 * data.roughness * data.ldoth * data.ldoth
        fl = torch.pow(1.0 - data.ndotl, 5.0)
        fv = torch.pow(1.0 - data.ndotv, 5.0)
        return (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    if cfg.diffuse == DiffuseModel.FROSTBITE:
        energy_bias = lerp(0.0, 0.5, data.roughness)
        energy_factor = lerp(1.0, 1.0 / 1.51, data.roughness)
        fd90 = energy_bias + 2.0 * data.roughness * data.ldoth * data.ldoth
        fl = torch.pow(1.0 - data.ndotl, 5.0)
        fv = torch.pow(1.0 - data.ndotv, 5.0)
        return (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv) * energy_factor
    raise ValueError(cfg.diffuse)


def eval_diffuse(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    return data.diffuse_reflectance * (diffuse_term(data, cfg) * ONE_OVER_PI
                                       * data.ndotl)[..., None]


def eval_microfacet(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    d = microfacet_d(torch.clamp(data.alpha_squared, min=0.00001), data.ndoth, cfg)
    g2 = smith_g2(data.alpha, data.alpha_squared, data.ndotl, data.ndotv, cfg)
    if g2_divided_by_denominator(cfg):
        return data.f * (g2 * d * data.ndotl)[..., None]
    return data.f * ((g2 * d) / (4.0 * torch.clamp(data.ndotv, min=1e-5)))[..., None]


def eval_phong(data: BrdfData, cfg: BRDFConfig = BRDFConfig()):
    shininess = 2.0 / torch.clamp(data.alpha_squared, min=1e-5) - 2.0
    r = 2.0 * data.ndotv[..., None] * data.n - data.v
    rdotl = torch.clamp(dot(normalize(r), data.l), min=0.0)
    norm = (shininess + 2.0) / (2.0 * PI)
    return data.specular_f0 * (norm * torch.pow(rdotl, shininess) * data.ndotl)[..., None]


def prepare_brdf_data(n, l, v, material: MaterialProperties,
                      cfg: BRDFConfig = BRDFConfig()) -> BrdfData:
    h = normalize(l + v)
    ndotl_raw = dot(n, l)
    ndotv_raw = dot(n, v)
    ndotl = torch.clamp(ndotl_raw, 0.00001, 1.0)
    ndotv = torch.clamp(ndotv_raw, 0.00001, 1.0)
    ldoth = saturate(dot(l, h))
    ndoth = saturate(dot(n, h))
    vdoth = saturate(dot(v, h))
    specular_f0 = base_color_to_specular_f0(
        material.base_color, material.metalness, material.reflectance, cfg)
    diffuse_reflectance = base_color_to_diffuse_reflectance(
        material.base_color, material.metalness)
    alpha = material.roughness * material.roughness
    f = eval_fresnel_schlick(specular_f0, shadowed_f90(specular_f0), ldoth)
    return BrdfData(
        specular_f0=specular_f0, diffuse_reflectance=diffuse_reflectance,
        roughness=material.roughness, alpha=alpha, alpha_squared=alpha * alpha,
        f=f, v=v, n=n, h=h, l=l, ndotl=ndotl, ndotv=ndotv,
        ldoth=ldoth, ndoth=ndoth, vdoth=vdoth,
        v_backfacing=(ndotv_raw <= 0.0), l_backfacing=(ndotl_raw <= 0.0))


def eval_combined_brdf(n, l, v, material: MaterialProperties,
                       cfg: BRDFConfig = BRDFConfig()):
    """Direct-light BRDF: (1-F)*diffuse + specular, zero if backfacing."""
    data = prepare_brdf_data(n, l, v, material, cfg)
    if cfg.specular == SpecularModel.MICROFACET:
        specular = eval_microfacet(data, cfg)
    elif cfg.specular == SpecularModel.PHONG:
        specular = eval_phong(data, cfg)
    else:
        specular = torch.zeros_like(data.f)
    diffuse = eval_diffuse(data, cfg)
    if cfg.combine_brdfs_with_fresnel:
        combined = (1.0 - data.f) * diffuse + specular
    else:
        combined = diffuse + specular
    mask = data.v_backfacing | data.l_backfacing
    return torch.where(mask[..., None], torch.zeros_like(combined), combined)


def eval_indirect_combined_brdf(u, shading_normal, geometry_normal, v,
                                material: MaterialProperties, brdf_type,
                                cfg: BRDFConfig = BRDFConfig()):
    """Sample the continuation ray; returns (ray_direction, weight, valid).
    Both lobes are evaluated and selected per lane by ``brdf_type``."""
    del geometry_normal  # the reference ignores it too
    q_rot = quat_rotation_to_z(shading_normal)
    v_local = quat_rotate(q_rot, v)

    dir_diffuse, _ = sampling.sample_hemisphere_cosine(u)
    data_d = prepare_brdf_data(
        constant([0.0, 0.0, 1.0], v).expand(v_local.shape),
        dir_diffuse, v_local, material, cfg)
    w_diffuse = data_d.diffuse_reflectance * diffuse_term(data_d, cfg)[..., None]
    h_spec = _sample_half_vector(
        v_local, torch.stack([data_d.alpha, data_d.alpha], dim=-1), u, cfg)
    vdoth = torch.clamp(dot(v_local, h_spec), 0.00001, 1.0)
    w_diffuse = w_diffuse * (1.0 - eval_fresnel_schlick(
        data_d.specular_f0, shadowed_f90(data_d.specular_f0), vdoth))

    dir_specular, w_specular = sample_specular_microfacet(
        v_local, data_d.alpha, data_d.alpha_squared, data_d.specular_f0, u, cfg)

    is_spec = (brdf_type == SPECULAR_TYPE)[..., None]
    ray_local = torch.where(is_spec, dir_specular, dir_diffuse)
    weight = torch.where(is_spec, w_specular, w_diffuse)

    valid = luminance(weight) != 0.0
    ray_dir = normalize(quat_rotate(quat_invert(q_rot), ray_local))
    return ray_dir, weight, valid


def get_brdf_probability(material: MaterialProperties, v, shading_normal):
    """Specular-vs-diffuse lottery probability."""
    f0 = luminance(base_color_to_specular_f0(material.base_color,
                                             material.metalness,
                                             material.reflectance))
    diff_refl = luminance(base_color_to_diffuse_reflectance(material.base_color,
                                                            material.metalness))
    fresnel_factor = torch.clamp(dot(v, shading_normal), min=0.0)
    f0_rgb = torch.stack([f0, f0, f0], dim=-1)
    fres = saturate(luminance(eval_fresnel_schlick(f0_rgb, shadowed_f90(f0_rgb),
                                                   fresnel_factor)))
    adjusted = fres * 0.5
    specular = adjusted
    diffuse = diff_refl * (1.0 - adjusted) * 1.5
    p = specular / torch.clamp(specular + diffuse, min=0.0001)
    return torch.clamp(p, 0.05, 0.7)
