"""Procedural test geometry; counterpart of ``physically_based_ray_tracer_tpu/scene/procedural.py``.

Outputs use the "fat" layout: per-corner positions (3T, 3), normals (3T, 3),
UVs (3T, 2), plus face normals (T, 3). Host-side numpy.
"""

from __future__ import annotations

import numpy as np


def _fat(verts, faces, normals=None, uvs=None):
    """Index -> fat per-corner arrays; face normals from the cross product."""
    tri = verts[faces]                              # (T, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    if normals is None:
        corner_n = np.repeat(fn, 3, axis=0)
    else:
        corner_n = normals[faces].reshape(-1, 3)
    if uvs is None:
        corner_uv = np.zeros((len(faces) * 3, 2), np.float32)
    else:
        corner_uv = uvs[faces].reshape(-1, 2)
    return (tri.reshape(-1, 3).astype(np.float32), corner_n.astype(np.float32),
            corner_uv.astype(np.float32), fn.astype(np.float32))


def make_sphere(center=(0, 0, 0), radius=1.0, lat=16, lon=32):
    """UV sphere with smooth vertex normals."""
    cs = np.asarray(center, np.float64)
    vs, ns, uv = [], [], []
    for i in range(lat + 1):
        theta = np.pi * i / lat
        for j in range(lon + 1):
            phi = 2 * np.pi * j / lon
            n = np.asarray([np.sin(theta) * np.cos(phi), np.cos(theta),
                            np.sin(theta) * np.sin(phi)])
            vs.append(cs + radius * n)
            ns.append(n)
            uv.append([j / lon, i / lat])
    verts = np.asarray(vs)
    normals = np.asarray(ns)
    uvs = np.asarray(uv)
    faces = []
    for i in range(lat):
        for j in range(lon):
            a = i * (lon + 1) + j
            b = a + lon + 1
            faces.append([a, b, a + 1])
            faces.append([a + 1, b, b + 1])
    faces = np.asarray(faces, np.int64)
    return _fat(verts, faces, normals, uvs)


def make_quad(p0, p1, p2, p3):
    """Two-triangle quad p0-p1-p2-p3 (counter-clockwise)."""
    verts = np.asarray([p0, p1, p2, p3], np.float64)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    return _fat(verts, faces, None, uvs)


def make_box(bmin, bmax, inward=False):
    """Axis-aligned box, faces wound outward (or inward for a room)."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    quads = [
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        ([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # -z
        ([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # +x
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        ([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # +y
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # -y
    ]
    parts = [make_quad(*q) for q in quads]
    if inward:
        parts = [(p[0].reshape(-1, 3, 3)[:, ::-1].reshape(-1, 3), -p[1], p[2], -p[3])
                 for p in parts]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


def make_cornell_walls(size=1.0):
    """Cornell-style room: white floor/ceiling/back, red left, green right.

    Returns list of (fat_arrays, base_color) so callers can assign materials
    per wall. Camera looks down -z into the open front.
    """
    s = size
    white = (0.73, 0.73, 0.73)
    red = (0.65, 0.05, 0.05)
    green = (0.12, 0.45, 0.15)
    # wound so face normals point INTO the room (the camera side): an
    # outward normal makes every clamped dot(N, L) zero and the interior
    # renders black (the Cornell golden pins this)
    walls = [
        (make_quad([-s, -s, -s], [-s, -s, s], [s, -s, s], [s, -s, -s]), white),   # floor
        (make_quad([-s, s, s], [-s, s, -s], [s, s, -s], [s, s, s]), white),        # ceiling
        (make_quad([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s]), white),    # back
        (make_quad([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s]), red),      # left
        (make_quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s]), green),        # right
    ]
    return walls
