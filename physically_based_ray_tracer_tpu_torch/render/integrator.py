"""Wavefront path-tracing integrator; counterpart of ``physically_based_ray_tracer_tpu/render/integrator.py``.

Every path vertex does one closest-hit traversal, one shading/NEE block with
one batched occlusion traversal (plus the NP-ray point pass when
``one_shadow_ray`` is off), and one continuation sample. Lanes die by
masking. The JAX package's ``lax.scan`` over bounces is a Python loop here.

A full-width chunk (``shade_tile`` 0) runs one body on every device and
engine, eager or recorded as a CUDA graph (``render/graph.py``), and reads
nothing on the host: every bounce runs the closest-hit pass and the whole
shading block, and the bf16 engine's retest always launches
(``trace_bf16._resolve_uncertain``). The JAX package's full-width
``lax.cond`` gates (a bounce with no live lane, a wavefront where no live
lane hit anything) skip that work instead; this is a deliberate
difference, and the results are equal: a dead or missed lane's radiance
takes ``+ 0`` through the block's masked sums, and a dead lane traces with
t_max 0 and sorts behind every live lane. With ``shade_tile > 0`` the
shading block runs once per slice of ``_snap_subtiles`` slices, each behind
the JAX package's two sub-tile gates, which are host checks here
(``_gated``): a slice with no live lane passes through, and a slice where
no live lane hit anything only settles the miss bookkeeping (sky radiance,
primary depth). Neither gate changes a result.

A missed live lane adds ``throughput * sample_skybox(sky, d)`` when
``cfg.skybox`` is set and the scene has a sky image, in the shading block
(lanes that missed, after the bf16-apron guard) and in a slice's all-miss
shortcut alike. AOV modes (``rendering_mode`` other than BRDF) shade the
primary hit only (``render_aov``); ``post_processed`` casts the primary
rays through the Panini projection.

The zero-contribution shadow-ray pruning (a shadow ray whose summed light
contribution is not > 0 gets tmax 0, in ``direct_lighting``) is the JAX
package's, kept for parity: it assumes nonnegative light colours, and a
light with a negative colour component renders as the JAX package renders
it.

Six engines are ported, dispatched as the JAX package dispatches them:
``traversal="pallas"`` with the bf16 engine (``leaf_precision="bf16"``, the
``RenderConfig`` default; ``ops/trace_bf16.py``, kernel B2, with its
uncertain occlusion lanes resolved by B1) or the exact f32 engine
(``leaf_precision="f32"``; ``ops/trace.py``, kernel B1);
``traversal="pallas_rows"``, the row-parallel exact engine
(``ops/trace_rows.py``, kernel B3: B1's function, one traversal per warp);
``traversal="wave"``, the wave engine over the scene's classic BVH
(``ops/traverse_packet.py``: the node scan ``csrc/wave_scan.cu`` and, for
``dense="mt"``, kernel B4 ``csrc/leaf_mt.cu``); and the two torch engines
over the classic BVH, ``traversal="packet"`` (``ops/traverse_packet.py``,
one shared stack per tile, on sorted rays where the JAX package sorts) and
``traversal="lane"`` (``ops/traverse.py``, one stack per ray, never
sorted). ``leaf_precision`` and ``refine`` do not apply to the last four.
As in the JAX package, tables with more than ``GLO_SMEM_LIMIT`` leaf groups
take the f32 engine even when bf16 is asked for; the launch counters show
which engine ran. Options the port does not carry raise
``NotImplementedError`` naming the option; see ``check_supported``.

With ``reshard_axis`` set (``parallel/shard.py::sharded_frame(...,
reshard_block=N)``), each bounce donates surplus live lanes to the next
rank of that axis's process group before the closest-hit pass and routes
their results home after the shading block (``parallel/resharding.py``),
whose live counts are read on the host.

Tracing (``utils/profiling.py``, on while a torch profiler records): each
bounce's closest-hit pass is a ``pbrt.closest`` span and its post-hit block
a ``pbrt.shade`` span (both with the bounce's ``depth``), each occlusion
pass a ``pbrt.occlusion`` span; the sub-tile gates read the device through
``host_read``.
"""

from __future__ import annotations

import dataclasses

import torch

from physically_based_ray_tracer_tpu_torch.bvh.dense import BF_ROWS
from physically_based_ray_tracer_tpu_torch.config import (
    BVH_FAR, EPSILON, P_DIRECTIONAL, P_POINT, P_SPOT, RenderConfig, RenderMode)
from physically_based_ray_tracer_tpu_torch.ops import brdf as brdf_ops
from physically_based_ray_tracer_tpu_torch.ops import (trace, trace_bf16, trace_rows,
                                                      traverse, traverse_packet)
from physically_based_ray_tracer_tpu_torch.ops.intersect import Hit
from physically_based_ray_tracer_tpu_torch.ops.take_rows import take_rows
from physically_based_ray_tracer_tpu_torch.ops.traverse import refine_hit
from physically_based_ray_tracer_tpu_torch.parallel.mesh import lookup
from physically_based_ray_tracer_tpu_torch.parallel.resharding import (ring_donate,
                                                                      ring_restore)
from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays, sample_skybox
from physically_based_ray_tracer_tpu_torch.scene.lights import sample_area_rect
from physically_based_ray_tracer_tpu_torch.scene.material import (
    gather_hit_attrs, geometry_normal, material_at_hit, material_packed,
    packed_tables, shading_normal, shading_normal_packed)
from physically_based_ray_tracer_tpu_torch.utils import rng
from physically_based_ray_tracer_tpu_torch.utils.math import (dot, reflect,
                                                              refract)
from physically_based_ray_tracer_tpu_torch.utils.profiling import annotate, host_read
from physically_based_ray_tracer_tpu_torch.utils.rng import Purpose


CLASSIC_ENGINES = ("wave", "packet", "lane")


def check_supported(cfg: RenderConfig, scene=None) -> None:
    """Raise NotImplementedError for every option this port does not carry:
    a traversal name the JAX package does not name (it traces those with
    the lane engine; the port refuses them), a leaf precision other than
    bf16 / f32, a wave leaf test other than mt / woop, an engine of the
    classic BVH (wave, packet, lane) on a scene without one. Ring
    resharding (``reshard_axis`` with ``reshard_ndev > 1``) needs a live
    process group registered under that name with that many ranks
    (``parallel/mesh.py::make_mesh``): without one, a RuntimeError."""
    if cfg.traversal not in ("pallas", "pallas_rows") + CLASSIC_ENGINES:
        raise NotImplementedError(
            f"traversal={cfg.traversal!r}: the port carries the dense-BVH "
            "engines (traversal='pallas' and 'pallas_rows') and the engines of "
            "the classic BVH (traversal='wave', 'packet' and 'lane')")
    if cfg.traversal == "wave" and cfg.dense not in ("mt", "woop"):
        raise NotImplementedError(f"dense={cfg.dense!r}: the wave engine's leaf "
                                  "test is 'mt' or 'woop'")
    if cfg.traversal in CLASSIC_ENGINES and scene is not None and scene.bvh is None:
        raise NotImplementedError(
            f"traversal={cfg.traversal!r} on a scene without a classic BVH "
            "(SceneData.bvh is None): build it with legacy_bvh=True")
    if cfg.leaf_precision not in ("bf16", "f32"):
        raise NotImplementedError(
            f"leaf_precision={cfg.leaf_precision!r}: the port carries 'bf16' "
            "and 'f32'")
    if resharded(cfg):
        mesh = lookup(cfg.reshard_axis)
        if mesh.size != cfg.reshard_ndev:
            raise ValueError(f"reshard_ndev={cfg.reshard_ndev}, but the group of "
                             f"reshard_axis={cfg.reshard_axis!r} has {mesh.size} ranks")


def _use_bf16(cfg: RenderConfig, dense) -> bool:
    """The bf16 engine runs when asked for, the table carries its bf16
    leaves, and it has at most GLO_SMEM_LIMIT groups (the JAX package's
    rule, kept for parity: larger tables take the f32 engine)."""
    if cfg.leaf_precision != "bf16" or dense is None:
        return False
    if not trace_bf16.has_bf16_tables(dense):
        return False
    return dense.groups_bf.shape[0] // BF_ROWS <= trace_bf16.GLO_SMEM_LIMIT


def table_bytes(scene, cfg: RenderConfig) -> int:
    """Bytes of the tables the traversal engine of ``cfg`` reads on
    ``scene``: B1 and B3 the dense nodes, instance rows and leaf records; B2
    those (B1 retests its uncertain lanes) and its group boxes, prim ids and
    band pairs; the classic-BVH engines the classic tree's arrays."""
    if cfg.traversal in ("wave", "packet", "lane"):
        return sum(getattr(scene.bvh, f.name).nbytes for f in dataclasses.fields(scene.bvh))
    names = ["nodes16", "inst16", "leaf_rec"]
    if cfg.traversal == "pallas" and _use_bf16(cfg, scene.dense):
        names += ["glo", "pids_c", "groups_bf2"]
    return sum(getattr(scene.dense, n).nbytes for n in names)


def _closest(scene, cfg: RenderConfig, o, d, t_max=None, sort=False,
             refine="exact") -> Hit:
    """refine="fast" (trace_paths): the bf16 engine decodes the prim only,
    the integrator refines (t, u, v) itself. The exact engines ignore it.

    The traversal is a discrete search and carries no gradient: the rays and
    t_max are detached here, for every engine (the JAX package's
    ``stop_gradient`` at its traversal calls). The differentiable (t, u, v)
    come from ``refine_hit`` over the hit triangle."""
    o, d, t_max = _detached(o, d, t_max)
    sort = sort and cfg.sort_rays
    if cfg.traversal == "pallas_rows":
        fn = trace_rows.sorted_rows_closest if sort else trace_rows.rows_closest_dense
        return fn(scene.dense, o, d, t_max)
    if cfg.traversal in ("wave", "packet"):
        tp = traverse_packet
        fn, kw = ((tp.intersect_closest_wave, _wave_kw(cfg)) if cfg.traversal == "wave"
                  else (tp.intersect_closest_packet, _packet_kw(cfg)))
        if sort:
            return tp.sorted_closest(fn, scene.bvh, o, d, t_max, **kw)
        return fn(scene.bvh, o, d, t_max, **kw)
    if cfg.traversal == "lane":
        return traverse.intersect_closest(scene.bvh, o, d, t_max,
                                          stack_depth=cfg.max_stack_depth,
                                          leaf_size=cfg.leaf_size)
    if _use_bf16(cfg, scene.dense):
        fn = trace_bf16.sorted_closest_bf16 if sort \
            else trace_bf16.intersect_closest_bf16
        return fn(scene.dense, o, d, t_max, refine=refine)
    fn = trace.sorted_closest_dense if sort else trace.intersect_closest_dense
    return fn(scene.dense, o, d, t_max)


def _detached(o, d, t_max):
    return o.detach(), d.detach(), None if t_max is None else t_max.detach()


def _packet_kw(cfg: RenderConfig) -> dict:
    return dict(tile=cfg.packet_tile, stack_depth=cfg.max_stack_depth,
                leaf_size=cfg.leaf_size)


def _wave_kw(cfg: RenderConfig) -> dict:
    return dict(_packet_kw(cfg), dense=cfg.dense, shrink=cfg.wave_shrink)


def _anyhit(scene, cfg: RenderConfig, o, d, t_max, sort=False) -> torch.Tensor:
    """Occlusion of each ray; the rays and t_max are detached, as in
    _closest. Every call is a ``pbrt.occlusion`` span."""
    with annotate("pbrt.occlusion"):
        o, d, t_max = _detached(o, d, t_max)
        sort = sort and cfg.sort_rays
        if cfg.traversal in ("wave", "packet"):
            tp = traverse_packet
            fn, kw = ((tp.intersect_any_wave, _wave_kw(cfg)) if cfg.traversal == "wave"
                      else (tp.intersect_any_packet, _packet_kw(cfg)))
            if sort:
                return tp.sorted_any(fn, scene.bvh, o, d, t_max, **kw)
            return fn(scene.bvh, o, d, t_max, **kw)
        if cfg.traversal == "lane":
            return traverse.intersect_any(scene.bvh, o, d, t_max,
                                          stack_depth=cfg.max_stack_depth,
                                          leaf_size=cfg.leaf_size)
        if cfg.traversal == "pallas_rows":
            fn = trace_rows.sorted_rows_any if sort else trace_rows.rows_any_dense
        elif _use_bf16(cfg, scene.dense):
            fn = trace_bf16.sorted_any_bf16 if sort else trace_bf16.intersect_any_bf16
        else:
            fn = trace.sorted_any_dense if sort else trace.intersect_any_dense
        return fn(scene.dense, o, d, t_max)


def resharded(cfg: RenderConfig) -> bool:
    """Ring resharding is on: a reshard axis over more than one rank."""
    return cfg.reshard_axis is not None and cfg.reshard_ndev > 1


def _light_type_weights(lights):
    """Active-light-type probabilities (0.3/0.5/0.2, plus 0.3 for area
    lights), renormalised over the types present."""
    w = [P_POINT * (lights.n_point > 0), P_DIRECTIONAL * (lights.n_dir > 0),
         P_SPOT * (lights.n_spot > 0), 0.3 * (lights.n_area > 0)]
    total = sum(w)
    if total == 0:
        return None
    return [x / total for x in w]


def _select(onehot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row of ``x`` (B, N, C) picked by a one-hot (B, N) — exact."""
    return torch.sum(onehot[..., None] * x, dim=1)


def direct_lighting(scene, cfg: RenderConfig, point, shading_n, v, material,
                    pixel_id, key, sample: int, depth: int, alive=None):
    """Stochastic next-event estimation; returns the vertex's radiance
    contribution (throughput not applied). ``key``: an integer seed or a
    ``rng.SeedTable``."""
    lights = scene.lights
    B = point.shape[0]
    zeros = torch.zeros((B, 3), dtype=point.dtype, device=point.device)
    live = torch.ones((B,), dtype=torch.bool, device=point.device) \
        if alive is None else alive

    weights = _light_type_weights(lights)
    if weights is None or not cfg.lighted:
        return zeros

    if cfg.stochastic_lights:
        u_pick = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_TYPE)
        p_point, p_dir, p_spot, p_area = weights
        pick_point = u_pick < p_point
        pick_dir = (~pick_point) & (u_pick < p_point + p_dir)
        pick_spot = (~pick_point) & (~pick_dir) & (u_pick < p_point + p_dir + p_spot)
        pick_area = (~pick_point) & (~pick_dir) & (~pick_spot) & (p_area > 0)
    else:
        if lights.n_dir == 0:
            return zeros
        p_dir = 1.0
        p_point = p_spot = p_area = 0.0
        pick_point = torch.zeros((B,), dtype=torch.bool, device=point.device)
        pick_dir = torch.ones_like(pick_point)
        pick_spot = torch.zeros_like(pick_point)
        pick_area = torch.zeros_like(pick_point)

    result = zeros
    point_one = None

    if lights.n_point > 0 and p_point > 0:
        np_ = lights.n_point
        lvec = lights.point_pos[None, :, :] - point[:, None, :]      # (B, NP, 3)
        dist_sq = torch.sum(lvec * lvec, dim=-1)
        dist = torch.sqrt(torch.clamp(dist_sq, min=1e-20))
        ldir = lvec / dist[..., None]
        cosa = torch.clamp(torch.sum(shading_n[:, None, :] * ldir, dim=-1), min=0.0)
        inv_dist = 1.0 / dist
        falloff = inv_dist * inv_dist if cfg.exact_point_falloff else inv_dist
        contrib = (lights.point_color[None] * lights.point_active[None, :, None]
                   * (falloff * cosa)[..., None])                     # (B, NP, 3)
        lane_ids = torch.arange(np_, dtype=torch.int32, device=point.device)
        u_sel = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_SELECT)
        # reference quirk: shadow tmax = dist^2 (exact_shadow_tmax: dist)
        shadow_len = dist if cfg.exact_shadow_tmax else dist_sq
        if cfg.one_shadow_ray:
            # one uniformly picked light, weighted by NP: one occlusion lane
            which = torch.clamp((u_sel * np_).to(torch.int32), max=np_ - 1)
            onehot = (lane_ids[None, :] == which[:, None]).to(point.dtype)
            l_sel = _select(onehot, ldir)
            c_sel = _select(onehot, contrib) * np_
            t_sel = torch.sum(onehot * shadow_len, dim=1)
            point_one = (l_sel, t_sel - EPSILON, c_sel / p_point)
        else:
            # all NP shadow rays in one light-major occlusion pass
            so = (point[:, None, :] + ldir * EPSILON).transpose(0, 1).reshape(np_ * B, 3)
            sd = ldir.transpose(0, 1).reshape(np_ * B, 3)
            keep = (pick_point & live)[:, None] & (torch.sum(contrib, dim=-1) > 0)
            tmax = torch.where(keep, shadow_len - EPSILON,
                               torch.zeros_like(shadow_len)).transpose(0, 1).reshape(np_ * B)
            occ = _anyhit(scene, cfg, so, sd, tmax, sort=True).reshape(np_, B).transpose(0, 1)
            visible = (~occ) & pick_point[:, None]
            point_contrib = torch.sum(torch.where(visible[..., None], contrib,
                                                  torch.zeros_like(contrib)), dim=1)
            point_contrib = point_contrib / p_point
            # specular BRDF from ONE randomly chosen light: int(u*10) % NP
            which = torch.remainder((u_sel * 10.0).to(torch.int32), np_)
            onehot = (lane_ids[None, :] == which[:, None]).to(point.dtype)
            l_sel = _select(onehot, ldir)
            bsdf = brdf_ops.eval_combined_brdf(shading_n, l_sel, v, material, cfg.brdf)
            result = result + torch.where(pick_point[:, None], bsdf * point_contrib,
                                          zeros)

    any_other = ((lights.n_dir > 0 and p_dir > 0) or (lights.n_spot > 0 and p_spot > 0)
                 or (lights.n_area > 0 and p_area > 0) or point_one is not None)
    if not any_other:
        return result
    l_dir = zeros
    t_other = torch.zeros((B,), dtype=point.dtype, device=point.device)
    contrib_other = zeros
    if point_one is not None:
        l_sel, t_sel, c_sel = point_one
        l_dir = torch.where(pick_point[:, None], l_sel, l_dir)
        t_other = torch.where(pick_point, t_sel, t_other)
        contrib_other = torch.where(pick_point[:, None], c_sel, contrib_other)
    if lights.n_dir > 0 and p_dir > 0:
        lvec = lights.dir_pos[0][None, :] - point
        dist = torch.sqrt(torch.clamp(torch.sum(lvec * lvec, dim=-1), min=1e-20))
        ld = lvec / dist[:, None]
        cosa = torch.clamp(dot(shading_n, ld), min=0.0)
        c = lights.dir_color[0][None, :] * cosa[:, None] / p_dir
        l_dir = torch.where(pick_dir[:, None], ld, l_dir)
        t_other = torch.where(pick_dir, dist - EPSILON, t_other)
        contrib_other = torch.where(pick_dir[:, None], c, contrib_other)
    if lights.n_spot > 0 and p_spot > 0:
        lvec = lights.spot_pos[0][None, :] - point
        dist = torch.sqrt(torch.clamp(torch.sum(lvec * lvec, dim=-1), min=1e-20))
        ld = lvec / dist[:, None]
        cosa = torch.clamp(dot(shading_n, ld), min=0.0)
        factor = dot(ld, lights.spot_rot[0][None, :])
        c = (lights.spot_color[0][None, :] * (cosa / (dist * dist))[:, None]
             * (factor > 0.9)[:, None].to(point.dtype)) / p_spot
        l_dir = torch.where(pick_spot[:, None], ld, l_dir)
        t_other = torch.where(pick_spot, dist - EPSILON, t_other)
        contrib_other = torch.where(pick_spot[:, None], c, contrib_other)
    if lights.n_area > 0 and p_area > 0:
        u_area = rng.uniform2(key, pixel_id, sample, depth, Purpose.AREA_LIGHT)
        u_sel = rng.uniform1(key, pixel_id, sample, depth, Purpose.LIGHT_SELECT)
        which = torch.remainder((u_sel * lights.n_area).to(torch.int32), lights.n_area)
        q, ln, pdf_area = sample_area_rect(lights, which.long(), u_area)
        lvec = q - point
        dist_sq = torch.clamp(torch.sum(lvec * lvec, dim=-1), min=1e-20)
        dist = torch.sqrt(dist_sq)
        ld = lvec / dist[:, None]
        cos_light = torch.clamp(-dot(ld, ln), min=0.0)
        col = take_rows(lights.area_color, which.long())
        c = col * (cos_light / (dist_sq * pdf_area * p_area
                                * float(lights.n_area)))[:, None] * float(lights.n_area)
        l_dir = torch.where(pick_area[:, None], ld, l_dir)
        t_other = torch.where(pick_area, dist - EPSILON, t_other)
        contrib_other = torch.where(pick_area[:, None], c, contrib_other)

    so = point + l_dir * EPSILON
    # zero-contribution shadow rays cannot change the result: mask them off
    t_other = torch.where(live & (torch.sum(contrib_other, dim=-1) > 0),
                          t_other, torch.zeros_like(t_other))
    occ = _anyhit(scene, cfg, so, l_dir, t_other, sort=True)
    bsdf = brdf_ops.eval_combined_brdf(shading_n, l_dir, v, material, cfg.brdf)
    picked = pick_dir | pick_spot | pick_area
    if point_one is not None:
        picked = picked | pick_point
    other = torch.where(((~occ) & picked)[:, None], bsdf * contrib_other, zeros)
    return result + other


def _snap_subtiles(B: int, target_w: int) -> int:
    """Sub-tile count of the shading block: the divisor of B whose
    quotient is nearest ``target_w`` (cfg.shade_tile). 1 = full width
    (disabled, or B too small to split)."""
    if target_w <= 0 or B <= target_w:
        return 1
    s0 = max(1, round(B / target_w))
    for ds in range(s0):
        for s in (s0 + ds, s0 - ds):
            if 1 < s <= B and B % s == 0:
                return s
    return 1


def _has_sky(scene, cfg: RenderConfig) -> bool:
    return cfg.skybox and scene.sky.shape[0] > 1


_CARRY = ("o", "d", "radiance", "throughput", "alive", "primary_t")


def _shade(scene, cfg: RenderConfig, packs, lanes: dict, key, sample: int,
           depth: int, debug: dict | None = None) -> dict:
    """The shading block of one vertex, whatever the slice holds (dead and
    missed lanes add nothing): refine, sky on the missed lanes, emission +
    NEE, continuation. A ``debug`` dict
    (``trace_paths(collect_debug=True)``) receives the vertex's hit,
    material and lighting state per lane."""
    o, d = lanes["o"], lanes["d"]
    radiance, throughput = lanes["radiance"], lanes["throughput"]
    alive, primary_t = lanes["alive"], lanes["primary_t"]
    prim, found0, pixel_id = lanes["prim"], lanes["found0"], lanes["pixel_id"]

    attrs = gather_hit_attrs(scene, packs, prim)
    rt, ru, rv = refine_hit(o, d, attrs["v0"], attrs["e1"], attrs["e2"],
                            mask=found0)
    # bf16-apron guard: a winner more than the accept apron outside its
    # triangle is a silhouette phantom, dropped; apron hits are clamped
    # to the simplex. Both are no-ops for the exact f32 engine.
    inside = torch.minimum(torch.minimum(ru, rv), 1.0 - ru - rv) > -0.02
    found = found0 & inside
    ru = torch.clamp(ru, 0.0, 1.0)
    rv = torch.minimum(torch.clamp(rv, min=0.0), torch.clamp(1.0 - ru, min=0.0))
    zero = torch.zeros_like(ru)
    hit_t = torch.where(found, rt, lanes["hit_t"])
    hit_u = torch.where(found, ru, zero)
    hit_v = torch.where(found, rv, zero)
    if depth == 0:
        primary_t = hit_t
    if _has_sky(scene, cfg):
        miss = alive & ~found
        radiance = radiance + torch.where(
            miss[:, None], throughput * sample_skybox(scene.sky, d),
            torch.zeros_like(radiance))
    alive = alive & found

    point = o + d * torch.where(found, hit_t, torch.ones_like(hit_t))[:, None]
    v = -d
    geom_n = attrs["face_n"]
    shad_n = shading_normal_packed(scene, attrs, hit_u, hit_v, cfg.normal_mapped)
    material = material_packed(scene, attrs, hit_u, hit_v)

    vertex_rad = throughput * material.emissive
    dl = direct_lighting(scene, cfg, point, shad_n, v, material, pixel_id,
                         key, sample, depth, alive=alive)
    vertex_rad = vertex_rad + throughput * dl

    last = depth == cfg.bounces - 1
    # the dielectric branch discards this vertex's own emissive+NEE,
    # except at the last vertex
    is_dielectric = (material.transmissivness == 1.0) & (not last)
    radiance = radiance + torch.where((alive & ~is_dielectric)[:, None],
                                      vertex_rad, torch.zeros_like(vertex_rad))

    # dielectric continuation: Fresnel russian roulette
    n1, n2 = 1.0, 1.46
    cos_theta = torch.clamp(-dot(d, shad_n), 0.0, 1.0)
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    fresnel = r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)
    fresnel = torch.where(k <= 0.0, torch.ones_like(fresnel), fresnel)
    u_diel = rng.uniform1(key, pixel_id, sample, depth, Purpose.DIELECTRIC)
    take_reflect = (u_diel < fresnel)[:, None]
    diel_dir = torch.where(take_reflect, reflect(d, shad_n),
                           refract(d, shad_n, eta))
    diel_org = torch.where(take_reflect, point + shad_n * EPSILON,
                           point - shad_n * EPSILON)

    # lobe selection: mirror fast path + RIS lottery
    is_mirror = (material.metalness == 1.0) & (material.roughness == 0.0)
    p_spec = brdf_ops.get_brdf_probability(material, v, shad_n)
    u_lobe = rng.uniform1(key, pixel_id, sample, depth, Purpose.LOBE_SELECT)
    pick_spec = (u_lobe < p_spec) | is_mirror
    lobe_div = torch.where(is_mirror, torch.ones_like(p_spec),
                           torch.where(pick_spec, p_spec, 1.0 - p_spec))
    brdf_type = torch.where(pick_spec, brdf_ops.SPECULAR_TYPE,
                            brdf_ops.DIFFUSE_TYPE).to(torch.int32)
    u2 = rng.uniform2(key, pixel_id, sample, depth, Purpose.BRDF_SAMPLE)
    bounce_dir, weight, valid = brdf_ops.eval_indirect_combined_brdf(
        u2, shad_n, geom_n, v, material, brdf_type, cfg.brdf)

    w_scaled = weight / lobe_div[:, None]
    diel = is_dielectric[:, None]
    throughput = throughput * torch.where(diel, torch.ones_like(w_scaled), w_scaled)
    o = torch.where(diel, diel_org, point + bounce_dir * EPSILON)
    d = torch.where(diel, diel_dir, bounce_dir)
    alive = alive & (is_dielectric | valid)
    if debug is not None:
        debug.update(
            hit_t=hit_t, hit_prim=torch.where(found, prim.to(torch.int32), -1),
            hit_u=hit_u, hit_v=hit_v, point=point, geom_n=geom_n, shad_n=shad_n,
            base_color=material.base_color, metalness=material.metalness,
            roughness=material.roughness,
            vertex_radiance=torch.where((lanes["alive_in"] & ~is_dielectric)[:, None],
                                        vertex_rad, torch.zeros_like(vertex_rad)),
            is_dielectric=is_dielectric, picked_specular=pick_spec)
    return dict(o=o, d=d, radiance=radiance, throughput=throughput, alive=alive,
                primary_t=primary_t)


def _skip_shade(scene, cfg: RenderConfig, lanes: dict, depth: int) -> dict:
    """A ``shade_tile`` slice where no lane hit anything: every live lane
    missed. Settle the miss bookkeeping (sky radiance, primary depth) and
    kill the slice."""
    out = {k: lanes[k] for k in _CARRY}
    if depth == 0:
        out["primary_t"] = lanes["hit_t"]
    if _has_sky(scene, cfg):
        out["radiance"] = out["radiance"] + torch.where(
            lanes["alive"][:, None],
            lanes["throughput"] * sample_skybox(scene.sky, lanes["d"]),
            torch.zeros_like(out["radiance"]))
    out["alive"] = torch.zeros_like(lanes["alive"])
    return out


def _dead_skip(lanes: dict, depth: int) -> dict:
    """Nothing alive in the ``shade_tile`` slice: pass-through (the
    primary-depth settle is the identity from bounce 1 on, where alone a
    dead slice can occur)."""
    out = {k: lanes[k] for k in _CARRY}
    if depth == 0:
        out["primary_t"] = lanes["hit_t"]
    return out


def _gated(scene, cfg: RenderConfig, packs, lanes: dict, key, sample: int,
           depth: int) -> dict:
    """The sub-tile gates of one ``shade_tile`` slice (the JAX package's
    ``lax.cond`` pair, host reads here): dead -> pass-through, no hit ->
    miss bookkeeping, else the shading block."""
    if not host_read("alive_in", lanes["alive_in"].any()):
        return _dead_skip(lanes, depth)
    if not host_read("found0", lanes["found0"].any()):
        return _skip_shade(scene, cfg, lanes, depth)
    return _shade(scene, cfg, packs, lanes, key, sample, depth)


def trace_paths(scene, cfg: RenderConfig, o, d, pixel_id, key, sample: int,
                collect_debug: bool = False):
    """Trace a batch of paths to completion; returns (radiance (B,3), primary Hit).
    ``key`` is an integer seed or a ``rng.SeedTable``.

    The closest-hit traversal runs at full width every bounce; the shading
    block after it runs once at full width with no gate (module
    docstring), or, with ``cfg.shade_tile > 0``, once per slice of
    ``B / _snap_subtiles(B, shade_tile)`` lanes, each behind its own gates
    (two host checks and its own sorted occlusion pass), in order.

    ``collect_debug=True`` (the per-pixel debugger's tap) also returns a
    third output: a dict of per-bounce records stacked as (bounces, B, ...)
    (the JAX package's keys: the vertex's hit, material and lighting state,
    its ray, the hit instance, and the throughput, liveness and direction
    leaving it). Every bounce then runs the whole shading block at full
    width, whatever ``shade_tile`` says (records exist for dead lanes too);
    the radiance is the untapped integrator's."""
    check_supported(cfg, scene)
    B = o.shape[0]
    dev = o.device
    packs = packed_tables(scene)
    radiance = torch.zeros((B, 3), dtype=o.dtype, device=dev)
    throughput = torch.ones((B, 3), dtype=o.dtype, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    primary_t = torch.full((B,), BVH_FAR, dtype=o.dtype, device=dev)
    records = []
    # Ring resharding (parallel/resharding.py): each bounce donates up to
    # reshard_block surplus live lanes to the ring neighbour before the
    # closest pass and routes their results home after the shading block;
    # a lane's result depends on its ray and pixel id, not on the rank that
    # traces it (up to the bf16 engine's exact ties, which follow the
    # batch). Off on one rank and when debugging.
    mesh = (lookup(cfg.reshard_axis) if resharded(cfg) and not collect_debug else None)

    for depth in range(cfg.bounces):
        pid = pixel_id
        if mesh is not None:
            lanes, alive, meta = ring_donate(
                dict(o=o, d=d, radiance=radiance, throughput=throughput,
                     primary_t=primary_t, pixel_id=pixel_id),
                alive, mesh, min(cfg.reshard_block, B), bounce=depth)
            o, d, radiance, throughput, primary_t, pid = (
                lanes[k] for k in ("o", "d", "radiance", "throughput", "primary_t",
                                   "pixel_id"))
        W = o.shape[0]
        S = 1 if collect_debug else _snap_subtiles(W, cfg.shade_tile)
        n = W // S
        t_init = torch.where(alive, torch.full_like(primary_t, BVH_FAR),
                             torch.zeros_like(primary_t))
        with annotate("pbrt.closest", depth=depth):
            hit = _closest(scene, cfg, o, d, t_init, sort=True, refine="fast")
        with annotate("pbrt.shade", depth=depth):
            lanes = dict(o=o, d=d, radiance=radiance, throughput=throughput,
                         alive=alive, primary_t=primary_t, hit_t=hit.t,
                         prim=hit.prim.clamp(min=0).long(), found0=hit.prim >= 0,
                         alive_in=alive, pixel_id=pid)
            if S == 1:
                rec = dict(ray_o=o, ray_d=d, hit_inst=hit.inst) if collect_debug else None
                out = _shade(scene, cfg, packs, lanes, key, sample, depth, debug=rec)
                if collect_debug:
                    records.append(dict(rec, throughput_out=out["throughput"],
                                        alive_out=out["alive"], next_dir=out["d"]))
            else:
                parts = [_gated(scene, cfg, packs,
                                {k: x[i * n:(i + 1) * n] for k, x in lanes.items()},
                                key, sample, depth)
                         for i in range(S)]
                out = {k: torch.cat([p[k] for p in parts]) for k in _CARRY}
        if mesh is not None:
            out = ring_restore({k: out[k] for k in _CARRY}, meta, mesh)
        o, d, radiance, throughput, alive, primary_t = (out[k] for k in _CARRY)

    neg1 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((B,), dtype=o.dtype, device=dev)
    primary_hit = Hit(t=primary_t, u=zero, v=zero.clone(), prim=neg1, inst=neg1.clone())
    if collect_debug:
        return radiance, primary_hit, {k: torch.stack([r[k] for r in records])
                                       for k in (records[0] if records else ())}
    return radiance, primary_hit


def render_aov(scene, cfg: RenderConfig, o, d):
    """Debug AOV views of the primary hits (``cfg.rendering_mode`` other
    than BRDF), through the unsorted closest-hit pass with its exact hit
    record. DEPTH is normalised by the batch's largest hit distance (the
    batch is a chunk of the frame); PRIMID hashes the prim id with a uint32
    multiply (done in int64, masked to 32 bits). Returns (color (B,3), Hit)."""
    hit = _closest(scene, cfg, o, d)
    prim = hit.prim.clamp(min=0).long()
    ok = (hit.prim >= 0)[:, None]
    ones = torch.ones((1, 3), dtype=o.dtype, device=o.device)
    mode = cfg.rendering_mode
    if mode == RenderMode.BASECOLOR:
        out = material_at_hit(scene, prim, hit.u, hit.v).base_color
    elif mode == RenderMode.METAL:
        out = material_at_hit(scene, prim, hit.u, hit.v).metalness[:, None] * ones
    elif mode == RenderMode.ROUGHNESS:
        out = material_at_hit(scene, prim, hit.u, hit.v).roughness[:, None] * ones
    elif mode == RenderMode.EMMISIVE:
        out = material_at_hit(scene, prim, hit.u, hit.v).emissive
    elif mode == RenderMode.GEOMETRYNORMAL:
        out = (geometry_normal(scene, prim) + 1.0) * 0.5
    elif mode == RenderMode.SHADINGNORMAL:
        out = (shading_normal(scene, prim, hit.u, hit.v, cfg.normal_mapped) + 1.0) * 0.5
    elif mode == RenderMode.DEPTH:
        t = torch.where(hit.prim >= 0, hit.t, torch.zeros_like(hit.t))
        out = (t / torch.clamp(torch.max(t), min=1e-9))[:, None] * ones
    elif mode == RenderMode.PRIMID:
        # lanes without a hit are masked below, so the clamped prim is safe
        h = (prim * 2654435761) & 0xFFFFFFFF
        out = torch.stack([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF],
                          dim=-1).to(torch.float32) / 255.0
    else:
        raise ValueError(mode)
    return torch.where(ok, out, torch.zeros_like(out)), hit


def render_sample(scene, cam, cfg: RenderConfig, key, sample: int,
                  pixel_ids: torch.Tensor):
    """One sample for a batch of pixels: primary ray at integer pixel
    coords (through the Panini projection when ``cfg.post_processed``),
    plus a jittered AA ray averaged 50/50 (both traced in one doubled
    batch, the second with pixel ids offset by n_pixels); an AOV mode
    shades the primary ray's hit only. ``key``: see ``trace_paths``. Returns (color (B,3), primary_t (B,))."""
    check_supported(cfg, scene)
    xs = torch.remainder(pixel_ids, cfg.width).to(torch.float32)
    ys = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(torch.float32)
    panini = cfg.post_processed
    o1, d1 = primary_rays(cam, xs, ys, cfg.width, cfg.height, panini=panini)
    if cfg.rendering_mode != RenderMode.BRDF:
        color, hit = render_aov(scene, cfg, o1, d1)
        return color, hit.t
    if cfg.antialias:
        b = pixel_ids.shape[0]
        j = rng.uniform2(key, pixel_ids, sample, 0, Purpose.AA_JITTER)
        o2, d2 = primary_rays(cam, xs + j[:, 0], ys + j[:, 1], cfg.width,
                              cfg.height, panini=panini)
        o = torch.cat([o1, o2])
        d = torch.cat([d1, d2])
        pid2 = torch.cat([pixel_ids, pixel_ids + cfg.n_pixels])
        r, hit = trace_paths(scene, cfg, o, d, pid2, key, sample)
        return 0.5 * (r[:b] + r[b:]), hit.t[:b]
    color, hit = trace_paths(scene, cfg, o1, d1, pixel_ids, key, sample)
    return color, hit.t
