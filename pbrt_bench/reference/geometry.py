"""The reference's scene: world-space triangles baked from the benchmark's
scene inputs, per-model materials, lights and camera; and its own
intersection.

Intersection: each instance's world triangles get an axis-aligned box; a
ray is tested against the triangles of every instance whose box it enters
within its range, by brute force (Moller-Trumbore, no backface culling, a
hit needs 0 < t < t_max), keeping the nearest (ties: the lower prim).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_bench.reference.shading import BVH_FAR, cross, dot, normalize

# pairs of (ray, triangle) per brute-force block
PAIR_BLOCK = {"cuda": 1 << 24, "cpu": 1 << 18}


def quat_from_euler(e) -> np.ndarray:
    rx, ry, rz = [np.asarray(x, np.float64) for x in e]
    cx, sx = np.cos(rx * 0.5), np.sin(rx * 0.5)
    cy, sy = np.cos(ry * 0.5), np.sin(ry * 0.5)
    cz, sz = np.cos(rz * 0.5), np.sin(rz * 0.5)
    return np.stack([sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
                     cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz])


def quat_to_matrix(q) -> np.ndarray:
    x, y, z, w = (float(c) for c in q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def trs(position, rotation, scale) -> np.ndarray:
    """T * R(Euler, GLM convention) * S as a float32 4x4."""
    m = np.eye(4)
    m[:3, :3] = quat_to_matrix(quat_from_euler(rotation)) @ np.diag(np.asarray(scale, np.float64))
    m[:3, 3] = np.asarray(position, np.float64)
    return m.astype(np.float32)


@dataclasses.dataclass
class RefScene:
    """Everything the reference integrator reads, as tensors of ``dtype``."""

    v0: torch.Tensor          # (P, 3) world
    e1: torch.Tensor
    e2: torch.Tensor
    face_n: torch.Tensor      # (P, 3)
    corner_n: torch.Tensor    # (P, 3, 3)
    prim_model: torch.Tensor  # (P,) int64
    prim_inst: torch.Tensor   # (P,) int64
    inst_range: list          # per instance (first prim, count)
    mat: dict                 # base (M,3), metal, rough, emissive (M,3), transmissive
    lights: dict              # point_pos ... area_v, (N, 3) each; point_active (NP,)
    cam_pos: torch.Tensor
    cam_target: torch.Tensor
    # the triangles rays are intersected with: the baked ones, kept when a
    # parameter update moves the shading triangles (the renderer's tables
    # stay as built; hits are refined on the moved triangles)
    hit_tris: tuple = ()

    def __post_init__(self):
        if not self.hit_tris:
            self.hit_tris = (self.v0.detach(), self.e1.detach(), self.e2.detach())

    @property
    def dtype(self):
        return self.v0.dtype


def bake(inputs: dict, device, dtype=torch.float32) -> RefScene:
    """World arrays of the scene inputs (``pbrt_bench.scenes.scene_inputs``):
    each instance's corners through its TRS, its normals through the
    inverse-transpose (then renormalised), concatenated in instance order."""
    models, instances = inputs["models"], inputs["instances"]
    tris, fns, cns, pm, pi, ranges = [], [], [], [], [], []
    start = 0
    for k, inst in enumerate(instances):
        mdl = models[inst["model"]]
        m = trs(inst["position"], inst["rotation"], inst["scale"])
        nrm = np.linalg.inv(m[:3, :3].astype(np.float64)).T.astype(np.float32)
        wc = (mdl["corners"] @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        wn = mdl["normals"] @ nrm.T
        wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-20)
        wf = mdl["face_normals"] @ nrm.T
        wf /= np.maximum(np.linalg.norm(wf, axis=1, keepdims=True), 1e-20)
        n = wc.shape[0] // 3
        tris.append(wc.reshape(n, 3, 3))
        fns.append(wf.astype(np.float32))
        cns.append(wn.astype(np.float32).reshape(n, 3, 3))
        pm.append(np.full(n, inst["model"], np.int64))
        pi.append(np.full(n, k, np.int64))
        ranges.append((start, n))
        start += n
    tri = np.concatenate(tris)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device, dtype)
    i = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(device)
    v0 = tri[:, 0]
    mats = {"base": [m["base_color"] for m in models], "metal": [m["metalness"] for m in models],
            "rough": [m["roughness"] for m in models],
            "emissive": [m["emissive"] for m in models],
            "transmissive": [m["transmissivness"] for m in models]}
    lights = {k: f(np.asarray(v, np.float32).reshape(-1, 3)) for k, v in inputs["lights"].items()}
    lights["point_active"] = torch.ones(lights["point_pos"].shape[0], device=device, dtype=dtype)
    return RefScene(v0=f(v0), e1=f(tri[:, 1] - v0), e2=f(tri[:, 2] - v0),
                    face_n=f(np.concatenate(fns)), corner_n=f(np.concatenate(cns)),
                    prim_model=i(np.concatenate(pm)), prim_inst=i(np.concatenate(pi)),
                    inst_range=ranges, mat={k: f(v) for k, v in mats.items()},
                    lights=lights, cam_pos=f(inputs["camera"]["pos"]),
                    cam_target=f(inputs["camera"]["target"]))


def _boxes(scene: RefScene):
    """Per-instance (lo, hi) of the world triangles, padded a little."""
    v0, e1, e2 = scene.hit_tris
    v = torch.stack([v0, v0 + e1, v0 + e2], 1).float()
    out = []
    for s, n in scene.inst_range:
        p = v[s:s + n].reshape(-1, 3)
        lo, hi = p.min(0).values, p.max(0).values
        pad = 1e-4 * (1.0 + (hi - lo).abs().max())
        out.append((lo - pad, hi + pad))
    return out


def _enters(o, d, lo, hi, t_max):
    """Rays (float32) whose segment (0, t_max) meets the box."""
    small = torch.where(d < 0, torch.full_like(d, -1e-20), torch.full_like(d, 1e-20))
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, small, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).max(-1).values
    tf = torch.maximum(t0, t1).min(-1).values
    return (tn <= tf) & (tf > 0) & (tn < t_max)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of rays (R, 1, 3) against triangles (1, K, 3):
    (t, hit) with hit = det ok, u, v >= 0, u + v <= 1, t > 0."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > 1e-9
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    return t, ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)


def intersect(scene: RefScene, o, d, t_max, closest: bool):
    """Closest hit (prim, -1 on a miss) or occlusion (bool) of each ray.
    Rays with t_max <= 0 are not traced. Inputs carry no gradient here."""
    o, d, t_max = o.detach(), d.detach(), t_max.detach()
    dev = o.device
    R = o.shape[0]
    best_t = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    block = PAIR_BLOCK["cuda" if dev.type == "cuda" else "cpu"]
    of, df = o.float(), d.float()
    for (lo, hi), (s, n) in zip(_boxes(scene), scene.inst_range):
        live = (best_t > 0) & ~occ
        cand = torch.nonzero(live & _enters(of, df, lo, hi, best_t.float()))[:, 0]
        if cand.numel() == 0:
            continue
        v0, e1, e2 = (x[s:s + n][None] for x in scene.hit_tris)
        step = max(1, block // n)
        for c in range(0, cand.numel(), step):
            idx = cand[c:c + step]
            t, hit = _mt(o[idx][:, None], d[idx][:, None], v0, e1, e2)
            hit = hit & (t < best_t[idx][:, None])
            if closest:
                t = torch.where(hit, t, torch.full_like(t, BVH_FAR))
                bt, k = torch.min(t, dim=1)
                better = bt < best_t[idx]
                best_t[idx] = torch.where(better, bt, best_t[idx])
                prim[idx] = torch.where(better, k + s, prim[idx])
            else:
                occ[idx] = occ[idx] | hit.any(dim=1)
    return prim if closest else occ


def refine_hit(o, d, v0, e1, e2, mask):
    """(t, u, v) of a known hit triangle, differentiable; zero where not
    ``mask``."""
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    det = torch.where(mask, det, torch.ones_like(det))
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    zero = torch.zeros_like(t)
    return (torch.where(mask, t, zero), torch.where(mask, u, zero),
            torch.where(mask, v, zero))


def primary_rays(scene: RefScene, xs, ys, width: int, height: int, cam_pos=None,
                 cam_target=None):
    """Pinhole rays through the screen plane at distance 2 (half extents
    aspect x 1), at fractional pixel coords."""
    pos = scene.cam_pos if cam_pos is None else cam_pos
    target = scene.cam_target if cam_target is None else cam_target
    up0 = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype, device=pos.device)
    ahead = normalize(target - pos)
    right = normalize(cross(ahead, up0))
    up = normalize(cross(right, ahead))
    aspect = width / height
    center = pos + ahead * 2.0
    top_left = center - aspect * right + up
    top_right = center + aspect * right + up
    bottom_left = center - aspect * right - up
    u = xs * (1.0 / width)
    v = ys * (1.0 / height)
    p = (top_left[None, :] + u[..., None] * (top_right - top_left)[None, :]
         + v[..., None] * (bottom_left - top_left)[None, :])
    d = normalize(p - pos)
    return pos.expand(d.shape), d
