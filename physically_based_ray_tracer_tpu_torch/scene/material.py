"""Hit-point shading queries; counterpart of ``physically_based_ray_tracer_tpu/scene/material.py``.

Two paths give the same values. The unpacked queries (``interpolate_uv``,
``geometry_normal``, ``shading_normal``, ``material_at_hit``) gather each
attribute by prim from the SoA tables; the AOV views use them. The
packed-table path, which the integrator's bounces use: per-prim attributes are concatenated once per trace
into a (P, 51) row (geometry, shading corners, per-prim material) so each
bounce gathers one row per hit, or into three packs for scenes above
MERGED_PACK_MAX_PRIMS. Texture taps are nearest-neighbour texel fetches
from a flat pool (albedo sRGB->linear, RMA: G = roughness, B = metalness,
emission raw RGB, normal map 2c/255 - 1).
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.ops.brdf import MaterialProperties
from physically_based_ray_tracer_tpu_torch.ops.take_rows import take_rows
from physically_based_ray_tracer_tpu_torch.utils.math import (normalize,
                                                              srgb_to_linear)

TEX_ALBEDO = 0
TEX_NORMAL = 1
TEX_RMA = 2
TEX_EMISSION = 3

MERGED_PACK_MAX_PRIMS = 262144


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with clamped indices (jnp.take mode="clip"); its backward,
    where ``arr`` needs a gradient, is take_rows's segmented sum."""
    return take_rows(arr, idx)


def _decode_rgb(texel: torch.Tensor) -> torch.Tensor:
    s = 1.0 / 255.0
    r = ((texel >> 16) & 0xFF).to(torch.float32) * s
    g = ((texel >> 8) & 0xFF).to(torch.float32) * s
    b = (texel & 0xFF).to(torch.float32) * s
    return torch.stack([r, g, b], dim=-1)


def _decode_normal(texel: torch.Tensor) -> torch.Tensor:
    s = 2.0 / 255.0
    r = ((texel >> 16) & 0xFF).to(torch.float32) * s - 1.0
    g = ((texel >> 8) & 0xFF).to(torch.float32) * s - 1.0
    b = (texel & 0xFF).to(torch.float32) * s - 1.0
    return torch.stack([r, g, b], dim=-1)


def fetch_texel(pool: torch.Tensor, record: torch.Tensor, uv: torch.Tensor):
    """Nearest-neighbour tap. record: (..., 3) = (offset, width, height);
    offset < 0 means "no texture". Returns (texel, has_texture_mask)."""
    offset, w, h = record[..., 0], record[..., 1], record[..., 2]
    has = offset >= 0
    ws = torch.clamp(w, min=1)
    hs = torch.clamp(h, min=1)
    # float->int32 truncation toward zero, then a sign-following remainder
    # (jnp's %), as the JAX package computes it
    iu = torch.remainder((uv[..., 0] * ws).to(torch.int32), ws)
    iv = torch.remainder((uv[..., 1] * hs).to(torch.int32), hs)
    idx = torch.clamp(offset, min=0) + iu + iv * ws
    return _take(pool, idx.to(torch.int64)), has


def interpolate_uv(scene, prim: torch.Tensor, u, v) -> torch.Tensor:
    """Barycentric UV: w*uv[c0] + u*uv[c1] + v*uv[c2]."""
    c0 = prim.long() * 3
    w = 1.0 - u - v
    uv0 = _take(scene.corner_uv, c0)
    uv1 = _take(scene.corner_uv, c0 + 1)
    uv2 = _take(scene.corner_uv, c0 + 2)
    return w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2


def geometry_normal(scene, prim: torch.Tensor) -> torch.Tensor:
    """World-space face normal (transforms are baked at scene build)."""
    return _take(scene.face_normal, prim.long())


def shading_normal(scene, prim: torch.Tensor, u, v,
                   normal_mapped: bool = True) -> torch.Tensor:
    """Interpolated vertex normal with optional TBN normal mapping."""
    prim = prim.long()
    c0 = prim * 3
    w = 1.0 - u - v
    n0 = _take(scene.corner_normal, c0)
    n1 = _take(scene.corner_normal, c0 + 1)
    n2 = _take(scene.corner_normal, c0 + 2)
    n = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2
    if not normal_mapped:
        return normalize(n)
    model = _take(scene.prim_model, prim).long()
    rec = _take(scene.tex_record, model)[..., TEX_NORMAL, :]
    uv = interpolate_uv(scene, prim, u, v)
    texel, has = fetch_texel(scene.texel_pool, rec, uv)
    ncol = _decode_normal(texel)
    # tangent frame from world edges + uv deltas
    e1 = _take(scene.tri_e1, prim)
    e2 = _take(scene.tri_e2, prim)
    uv0 = _take(scene.corner_uv, c0)
    duv1 = _take(scene.corner_uv, c0 + 1) - uv0
    duv2 = _take(scene.corner_uv, c0 + 2) - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    t = normalize(inv_det[..., None] * (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2))
    b = normalize(inv_det[..., None] * (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2))
    nw = normalize(n)
    mapped = normalize(ncol[..., 0:1] * t + ncol[..., 1:2] * b + ncol[..., 2:3] * nw)
    return torch.where(has[..., None], mapped, nw)


def material_at_hit(scene, prim: torch.Tensor, u, v) -> MaterialProperties:
    """Material fetch: per-model constants, overridden by the albedo, RMA
    (G = roughness, B = metalness) and emission textures where present."""
    prim = prim.long()
    model = _take(scene.prim_model, prim).long()
    uv = interpolate_uv(scene, prim, u, v)
    recs = _take(scene.tex_record, model)          # (..., 4, 3)
    albedo_texel, has_albedo = fetch_texel(scene.texel_pool,
                                           recs[..., TEX_ALBEDO, :], uv)
    base_tex = srgb_to_linear(_decode_rgb(albedo_texel))
    base = torch.where(has_albedo[..., None], base_tex,
                       _take(scene.mat_base, model))
    rma_texel, has_rma = fetch_texel(scene.texel_pool, recs[..., TEX_RMA, :], uv)
    rma = _decode_rgb(rma_texel)
    rough = torch.where(has_rma, rma[..., 1], _take(scene.mat_rough, model))
    metal = torch.where(has_rma, rma[..., 2], _take(scene.mat_metal, model))
    emis_texel, has_emis = fetch_texel(scene.texel_pool,
                                       recs[..., TEX_EMISSION, :], uv)
    emissive = torch.where(has_emis[..., None], _decode_rgb(emis_texel),
                           _take(scene.mat_emissive, model))
    return MaterialProperties(
        base_color=base, metalness=metal, emissive=emissive, roughness=rough,
        transmissivness=_take(scene.mat_transmissive, model),
        reflectance=_take(scene.mat_reflectance, model),
        opacity=_take(scene.mat_opacity, model))


def packed_tables(scene):
    """(geom (P,13), shade (P,15), mat (M,11[+12]), recs_packed), or the
    merged (P,51) row with shade/mat None when P <= MERGED_PACK_MAX_PRIMS."""
    P = scene.tri_v0.shape[0]
    geom = torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2,
                      scene.face_normal,
                      scene.prim_model.to(torch.float32)[:, None]], dim=1)
    shade = torch.cat([scene.corner_normal.reshape(P, 9),
                       scene.corner_uv.reshape(P, 6)], dim=1)
    mat_cols = [scene.mat_base,
                scene.mat_metal[:, None],
                scene.mat_rough[:, None],
                scene.mat_emissive,
                scene.mat_transmissive[:, None],
                scene.mat_reflectance[:, None],
                scene.mat_opacity[:, None]]
    recs_packed = int(scene.texel_pool.shape[0]) < (1 << 24)
    if recs_packed:
        M = scene.tex_record.shape[0]
        mat_cols.append(scene.tex_record.reshape(M, 12).to(torch.float32))
    mat = torch.cat(mat_cols, dim=1)
    if P <= MERGED_PACK_MAX_PRIMS:
        mat_pp = _take(mat, scene.prim_model.to(torch.int64))
        merged = torch.cat([geom, shade, mat_pp], dim=1)
        return merged, None, None, recs_packed
    return geom, shade, mat, recs_packed


def gather_hit_attrs(scene, packs, prim: torch.Tensor) -> dict:
    """Per-hit attribute slices for a batch of hit prims."""
    geom, shade, mat, recs_packed = packs
    B = prim.shape[0]
    if shade is None:
        gs = _take(geom, prim)                            # (B, 51)
        g, s, m = gs[:, 0:13], gs[:, 13:28], gs[:, 28:]
    else:
        g = _take(geom, prim)                             # (B, 13)
        s = _take(shade, prim)                            # (B, 15)
        m = _take(mat, g[:, 12].to(torch.int64))          # (B, 11[+12])
    if recs_packed:
        recs = torch.round(m[:, 11:23]).to(torch.int32).reshape(B, 4, 3)
    else:
        recs = _take(scene.tex_record, g[:, 12].to(torch.int64))
    return dict(v0=g[:, 0:3], e1=g[:, 3:6], e2=g[:, 6:9],
                face_n=g[:, 9:12],
                n0=s[:, 0:3], n1=s[:, 3:6], n2=s[:, 6:9],
                uv0=s[:, 9:11], uv1=s[:, 11:13], uv2=s[:, 13:15],
                mat=m, recs=recs)


def _interp_uv_attr(a: dict, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    w = 1.0 - u - v
    return (w[..., None] * a["uv0"] + u[..., None] * a["uv1"]
            + v[..., None] * a["uv2"])


def shading_normal_packed(scene, a: dict, u, v, normal_mapped: bool = True):
    """Interpolated vertex normal with optional TBN normal mapping."""
    w = 1.0 - u - v
    n = (w[..., None] * a["n0"] + u[..., None] * a["n1"]
         + v[..., None] * a["n2"])
    if not normal_mapped:
        return normalize(n)
    rec = a["recs"][..., TEX_NORMAL, :]
    uv = _interp_uv_attr(a, u, v)
    texel, has = fetch_texel(scene.texel_pool, rec, uv)
    ncol = _decode_normal(texel)
    duv1 = a["uv1"] - a["uv0"]
    duv2 = a["uv2"] - a["uv0"]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    t = normalize(inv_det[..., None]
                  * (duv2[..., 1:2] * a["e1"] - duv1[..., 1:2] * a["e2"]))
    b = normalize(inv_det[..., None]
                  * (-duv2[..., 0:1] * a["e1"] + duv1[..., 0:1] * a["e2"]))
    nw = normalize(n)
    mapped = normalize(ncol[..., 0:1] * t + ncol[..., 1:2] * b
                       + ncol[..., 2:3] * nw)
    return torch.where(has[..., None], mapped, nw)


def material_packed(scene, a: dict, u, v) -> MaterialProperties:
    """Material fetch from pre-gathered attrs."""
    m = a["mat"]
    recs = a["recs"]
    uv = _interp_uv_attr(a, u, v)
    albedo_texel, has_albedo = fetch_texel(scene.texel_pool,
                                           recs[..., TEX_ALBEDO, :], uv)
    base_tex = srgb_to_linear(_decode_rgb(albedo_texel))
    base = torch.where(has_albedo[..., None], base_tex, m[:, 0:3])
    rma_texel, has_rma = fetch_texel(scene.texel_pool,
                                     recs[..., TEX_RMA, :], uv)
    rma = _decode_rgb(rma_texel)
    rough = torch.where(has_rma, rma[..., 1], m[:, 4])
    metal = torch.where(has_rma, rma[..., 2], m[:, 3])
    emis_texel, has_emis = fetch_texel(scene.texel_pool,
                                       recs[..., TEX_EMISSION, :], uv)
    emissive = torch.where(has_emis[..., None], _decode_rgb(emis_texel),
                           m[:, 5:8])
    return MaterialProperties(
        base_color=base, metalness=metal, emissive=emissive, roughness=rough,
        transmissivness=m[:, 8], reflectance=m[:, 9], opacity=m[:, 10])
