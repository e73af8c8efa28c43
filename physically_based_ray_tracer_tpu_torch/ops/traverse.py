"""Hit refinement; counterpart of ``refine_hit`` in ``physically_based_ray_tracer_tpu/ops/traverse.py``.

The lane engine of that module (``intersect_closest`` / ``intersect_any``,
``traversal="lane"``) is not ported; the wave engine is
``ops/traverse_packet.py``.
"""

from __future__ import annotations

import torch

from physically_based_ray_tracer_tpu_torch.utils.math import cross


def refine_hit(o, d, v0, e1, e2, mask=None):
    """(t, u, v) of a known hit triangle, recomputed from the original-order
    world triangle. ``mask`` marks lanes with a real hit; the others get
    sanitised inputs before the division and zero outputs."""
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    if mask is not None:
        det = torch.where(mask, det, torch.ones_like(det))
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    if mask is not None:
        zero = torch.zeros_like(t)
        t = torch.where(mask, t, zero)
        u = torch.where(mask, u, zero)
        v = torch.where(mask, v, zero)
    return t, u, v
