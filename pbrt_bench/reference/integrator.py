"""The reference path tracer: one sample of a batch of pixels, the film's
accumulation, and the count of the queries a frame traces.

The path is the renderer's, for the configurations the benchmark runs
(BRDF mode, gamma-corrected film with depth-keyed accumulation, a jittered
AA ray averaged 50/50 with the pixel-corner ray, stochastic NEE over the
point / directional / spot / area lights with one shadow ray, no sky, no
textures, no Panini): every vertex one closest hit, emission plus NEE with
one occlusion query, a Fresnel coin for dielectrics, then the lobe lottery
and a BRDF sample. Lanes die by masking, as in the renderer; only live
lanes are intersected.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_bench.reference import rng
from pbrt_bench.reference.geometry import RefScene, intersect, primary_rays, refine_hit
from pbrt_bench.reference.rng import Purpose
from pbrt_bench.reference.shading import (BVH_FAR, EPSILON, Material, cross, dot,
                                          eval_brdf, normalize, reflect, refract,
                                          sample_brdf, specular_probability)

P_POINT, P_DIRECTIONAL, P_SPOT, P_AREA = 0.3, 0.5, 0.2, 0.3


class QueryCount:
    """Live queries traced: closest-hit lanes alive at their bounce, and
    occlusion lanes with a positive range."""

    def __init__(self):
        self.closest = 0
        self.any = 0


def morton_order(width: int, height: int) -> np.ndarray:
    """Pixel ids in Z-curve order: the film's slot order."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.uint64)

    def spread(x):
        x &= 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        return (x | (x << 1)) & 0x55555555

    code = spread(xs) | (spread(ys) << 1)
    return (ys * width + xs).ravel()[np.argsort(code.ravel(), kind="stable")].astype(np.int64)


def _weights(lights: dict):
    n = {k: lights[k + "_pos"].shape[0] for k in ("point", "dir", "spot", "area")}
    w = [P_POINT * (n["point"] > 0), P_DIRECTIONAL * (n["dir"] > 0),
         P_SPOT * (n["spot"] > 0), P_AREA * (n["area"] > 0)]
    return n, [x / sum(w) for x in w]


def direct_light(scene: RefScene, point, n_s, v, mat: Material, pid, key, sample, depth,
                 live, counts: QueryCount | None):
    """Stochastic NEE with one shadow ray; the vertex's contribution before
    throughput."""
    L = scene.lights
    B = point.shape[0]
    zeros = torch.zeros((B, 3), dtype=point.dtype, device=point.device)
    n, (p_point, p_dir, p_spot, p_area) = _weights(L)
    u_pick = rng.uniform1(key, pid, sample, depth, Purpose.LIGHT_TYPE, point.dtype)
    pick_point = u_pick < p_point
    pick_dir = (~pick_point) & (u_pick < p_point + p_dir)
    pick_spot = (~pick_point) & (~pick_dir) & (u_pick < p_point + p_dir + p_spot)
    pick_area = (~pick_point) & (~pick_dir) & (~pick_spot) & (p_area > 0)
    l_dir, t_other, contrib = zeros, torch.zeros_like(u_pick), zeros
    picked = torch.zeros_like(pick_point)
    if n["point"] > 0 and p_point > 0:
        np_ = n["point"]
        lvec = L["point_pos"][None] - point[:, None, :]
        dist_sq = torch.sum(lvec * lvec, dim=-1)
        dist = torch.sqrt(torch.clamp(dist_sq, min=1e-20))
        ldir = lvec / dist[..., None]
        cosa = torch.clamp(torch.sum(n_s[:, None, :] * ldir, dim=-1), min=0.0)
        c_all = (L["point_color"][None] * L["point_active"][None, :, None]
                 * ((1.0 / dist) * cosa)[..., None])
        u_sel = rng.uniform1(key, pid, sample, depth, Purpose.LIGHT_SELECT, point.dtype)
        which = torch.clamp((u_sel.float() * np_).to(torch.int32), max=np_ - 1)
        onehot = (torch.arange(np_, device=point.device)[None, :] == which[:, None]).to(point.dtype)
        l_sel = torch.sum(onehot[..., None] * ldir, dim=1)
        c_sel = torch.sum(onehot[..., None] * c_all, dim=1) * np_
        t_sel = torch.sum(onehot * dist_sq, dim=1)        # the reference's dist^2 quirk
        l_dir = torch.where(pick_point[:, None], l_sel, l_dir)
        t_other = torch.where(pick_point, t_sel - EPSILON, t_other)
        contrib = torch.where(pick_point[:, None], c_sel / p_point, contrib)
        picked = picked | pick_point
    for kind, pick, p in (("dir", pick_dir, p_dir), ("spot", pick_spot, p_spot)):
        if n[kind] == 0 or p == 0:
            continue
        lvec = L[kind + "_pos"][0][None, :] - point
        dist = torch.sqrt(torch.clamp(torch.sum(lvec * lvec, dim=-1), min=1e-20))
        ld = lvec / dist[:, None]
        cosa = torch.clamp(dot(n_s, ld), min=0.0)
        if kind == "dir":
            c = L["dir_color"][0][None, :] * cosa[:, None] / p
        else:
            factor = dot(ld, L["spot_rot"][0][None, :])
            c = (L["spot_color"][0][None, :] * (cosa / (dist * dist))[:, None]
                 * (factor > 0.9)[:, None].to(point.dtype)) / p
        l_dir = torch.where(pick[:, None], ld, l_dir)
        t_other = torch.where(pick, dist - EPSILON, t_other)
        contrib = torch.where(pick[:, None], c, contrib)
        picked = picked | pick
    if n["area"] > 0 and p_area > 0:
        na = n["area"]
        u_area = rng.uniform2(key, pid, sample, depth, Purpose.AREA_LIGHT, point.dtype)
        u_sel = rng.uniform1(key, pid, sample, depth, Purpose.LIGHT_SELECT, point.dtype)
        which = torch.remainder((u_sel.float() * na).to(torch.int32), na).long().clamp(0, na - 1)
        eu, ev = L["area_u"][which], L["area_v"][which]
        q = (L["area_pos"][which] + (2.0 * u_area[..., 0:1] - 1.0) * eu
             + (2.0 * u_area[..., 1:2] - 1.0) * ev)
        ln = cross(eu, ev)
        area = 4.0 * torch.linalg.norm(ln, dim=-1)
        ln = ln / torch.clamp(torch.linalg.norm(ln, dim=-1, keepdim=True), min=1e-20)
        pdf = 1.0 / torch.clamp(area, min=1e-20)
        lvec = q - point
        dist_sq = torch.clamp(torch.sum(lvec * lvec, dim=-1), min=1e-20)
        dist = torch.sqrt(dist_sq)
        ld = lvec / dist[:, None]
        cos_light = torch.clamp(-dot(ld, ln), min=0.0)
        c = L["area_color"][which] * (cos_light / (dist_sq * pdf * p_area * float(na)))[:, None] \
            * float(na)
        l_dir = torch.where(pick_area[:, None], ld, l_dir)
        t_other = torch.where(pick_area, dist - EPSILON, t_other)
        contrib = torch.where(pick_area[:, None], c, contrib)
        picked = picked | pick_area
    so = point + l_dir * EPSILON
    t_other = torch.where(live & (torch.sum(contrib, dim=-1) > 0), t_other,
                          torch.zeros_like(t_other))
    if counts is not None:
        counts.any += int((t_other > 0).sum())
    occ = intersect(scene, so, l_dir, t_other, closest=False)
    bsdf = eval_brdf(n_s, l_dir, v, mat)
    return torch.where(((~occ) & picked)[:, None], bsdf * contrib, zeros)


def trace_paths(scene: RefScene, o, d, pid, key: int, sample: int, bounces: int,
                counts: QueryCount | None = None):
    """Radiance (B, 3) and primary hit distance (B,) of a batch of paths."""
    B = o.shape[0]
    dt, dev = o.dtype, o.device
    radiance = torch.zeros((B, 3), dtype=dt, device=dev)
    throughput = torch.ones((B, 3), dtype=dt, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    primary_t = torch.full((B,), BVH_FAR, dtype=dt, device=dev)
    m = scene.mat
    for depth in range(bounces):
        if not bool(alive.any()):
            break
        t_init = torch.where(alive, torch.full_like(primary_t, BVH_FAR),
                             torch.zeros_like(primary_t))
        if counts is not None:
            counts.closest += int(alive.sum())
        prim = intersect(scene, o, d, t_init, closest=True)
        found0 = prim >= 0
        p = prim.clamp(min=0)
        rt, ru, rv = refine_hit(o, d, scene.v0[p], scene.e1[p], scene.e2[p], found0)
        found = found0 & (torch.minimum(torch.minimum(ru, rv), 1.0 - ru - rv) > -0.02)
        ru = torch.clamp(ru, 0.0, 1.0)
        rv = torch.minimum(torch.clamp(rv, min=0.0), torch.clamp(1.0 - ru, min=0.0))
        hit_t = torch.where(found, rt, t_init)
        hit_u = torch.where(found, ru, torch.zeros_like(ru))
        hit_v = torch.where(found, rv, torch.zeros_like(rv))
        if depth == 0:
            primary_t = hit_t
        alive = alive & found
        point = o + d * torch.where(found, hit_t, torch.ones_like(hit_t))[:, None]
        v = -d
        geom_n = scene.face_n[p]
        cn = scene.corner_n[p]
        w = 1.0 - hit_u - hit_v
        n_s = normalize(w[:, None] * cn[:, 0] + hit_u[:, None] * cn[:, 1]
                        + hit_v[:, None] * cn[:, 2])
        mi = scene.prim_model[p]
        mat = Material(base_color=m["base"][mi], metalness=m["metal"][mi],
                       emissive=m["emissive"][mi], roughness=m["rough"][mi],
                       transmissivness=m["transmissive"][mi])
        vertex = throughput * mat.emissive
        vertex = vertex + throughput * direct_light(scene, point, n_s, v, mat, pid, key,
                                                    sample, depth, alive, counts)
        last = depth == bounces - 1
        dielectric = (mat.transmissivness == 1.0) & (not last)
        radiance = radiance + torch.where((alive & ~dielectric)[:, None], vertex,
                                          torch.zeros_like(vertex))
        # dielectric continuation: Fresnel russian roulette
        n1, n2 = 1.0, 1.46
        cos_theta = torch.clamp(-dot(d, n_s), 0.0, 1.0)
        eta = n1 / n2
        k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        fresnel = r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)
        fresnel = torch.where(k <= 0.0, torch.ones_like(fresnel), fresnel)
        u_diel = rng.uniform1(key, pid, sample, depth, Purpose.DIELECTRIC, dt)
        take_reflect = (u_diel < fresnel)[:, None]
        diel_dir = torch.where(take_reflect, reflect(d, n_s), refract(d, n_s, eta))
        diel_org = torch.where(take_reflect, point + n_s * EPSILON, point - n_s * EPSILON)
        # lobe lottery (mirror fast path) and the BRDF sample
        mirror = (mat.metalness == 1.0) & (mat.roughness == 0.0)
        p_spec = specular_probability(mat, v, n_s)
        u_lobe = rng.uniform1(key, pid, sample, depth, Purpose.LOBE_SELECT, dt)
        pick_spec = (u_lobe < p_spec) | mirror
        lobe_div = torch.where(mirror, torch.ones_like(p_spec),
                               torch.where(pick_spec, p_spec, 1.0 - p_spec))
        u2 = rng.uniform2(key, pid, sample, depth, Purpose.BRDF_SAMPLE, dt)
        bounce_dir, weight, valid = sample_brdf(u2, n_s, v, mat, pick_spec)
        del geom_n
        w_scaled = weight / lobe_div[:, None]
        diel = dielectric[:, None]
        throughput = throughput * torch.where(diel, torch.ones_like(w_scaled), w_scaled)
        o = torch.where(diel, diel_org, point + bounce_dir * EPSILON)
        d = torch.where(diel, diel_dir, bounce_dir)
        alive = alive & (dielectric | valid)
    return radiance, primary_t


def render_sample(scene: RefScene, pixel_ids, key: int, sample: int, width: int,
                  height: int, bounces: int, counts: QueryCount | None = None,
                  cam_pos=None, cam_target=None):
    """One sample of pixels ``pixel_ids`` (int64): the corner ray and a
    jittered ray (RNG pixel id offset by the pixel count), averaged.
    Returns (color (B, 3), primary t (B,))."""
    dt = scene.dtype
    xs = torch.remainder(pixel_ids, width).to(dt)
    ys = torch.div(pixel_ids, width, rounding_mode="floor").to(dt)
    o1, d1 = primary_rays(scene, xs, ys, width, height, cam_pos, cam_target)
    j = rng.uniform2(key, pixel_ids, sample, 0, Purpose.AA_JITTER, dt)
    o2, d2 = primary_rays(scene, xs + j[:, 0], ys + j[:, 1], width, height, cam_pos,
                          cam_target)
    b = pixel_ids.shape[0]
    r, t = trace_paths(scene, torch.cat([o1, o2]), torch.cat([d1, d2]),
                       torch.cat([pixel_ids, pixel_ids + width * height]), key, sample,
                       bounces, counts)
    return 0.5 * (r[:b] + r[b:]), t[:b]


def film_update(accum, spp, dist, color, primary_t):
    """The film's step: gamma (sqrt) on the frame's color, then the running
    sum, reset where the primary distance moved by EPSILON or more.
    Returns (accum, spp, dist, displayed mean)."""
    pos = color > 0.0
    color = torch.where(pos, torch.sqrt(torch.where(pos, color, 1.0)), torch.zeros_like(color))
    same = torch.abs(dist - primary_t) < EPSILON
    new_spp = torch.where(same, spp + 1.0, torch.ones_like(spp))
    new_accum = torch.where(same[:, None], accum + color, color)
    return new_accum, new_spp, primary_t, new_accum / new_spp[:, None]
