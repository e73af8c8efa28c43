"""Ray-triangle primitives; counterpart of ``physically_based_ray_tracer_tpu/ops/intersect.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from physically_based_ray_tracer_tpu_torch.config import BVH_FAR
from physically_based_ray_tracer_tpu_torch.utils.math import cross, dot


class Hit(NamedTuple):
    """SoA hit record {t, u, v, prim, inst}; prim/inst are -1 on a miss."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim: torch.Tensor   # int32
    inst: torch.Tensor   # int32


def intersect_tri(o, d, v0, e1, e2, t_max, eps: float = 1e-9):
    """Möller-Trumbore without backface culling. Returns (t, u, v, hit);
    hits at >= t_max are rejected."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > eps
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < t_max)
    return t, u, v, hit


def safe_rcp(d: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Reciprocal direction with sign-preserving zero protection."""
    small = torch.where(d < 0, torch.full_like(d, -eps), torch.full_like(d, eps))
    return 1.0 / torch.where(torch.abs(d) < eps, small, d)


def brute_force_intersect(o, d, tri_v0, tri_e1, tri_e2, t_max=None) -> Hit:
    """O(rays x tris) closest-hit reference (testing oracle; no BVH).
    o, d: (B, 3); tris: (P, 3). Returns a Hit with inst=0."""
    B = o.shape[0]
    if t_max is None:
        t_max = torch.full((B,), BVH_FAR, dtype=o.dtype, device=o.device)
    t, u, v, hit = intersect_tri(
        o[:, None, :], d[:, None, :],
        tri_v0[None, :, :], tri_e1[None, :, :], tri_e2[None, :, :],
        t_max[:, None])
    t = torch.where(hit, t, torch.full_like(t, BVH_FAR))
    bt, best = torch.min(t, dim=1)
    bu = torch.gather(u, 1, best[:, None])[:, 0]
    bv = torch.gather(v, 1, best[:, None])[:, 0]
    found = bt < BVH_FAR
    zero = torch.zeros_like(bu)
    prim = torch.where(found, best.to(torch.int32), -1)
    return Hit(t=bt, u=torch.where(found, bu, zero),
               v=torch.where(found, bv, zero), prim=prim,
               inst=torch.where(found, 0, -1).to(torch.int32))
