"""The benchmark's scene inputs, made from a configuration file.

A configuration (``configs/<name>.json``) states its meshes as procedural
shapes (UV spheres, quads), its materials, instances, lights, camera and
render settings. ``scene_inputs`` turns it into host arrays: per model the
"fat" per-corner positions, normals and UVs plus face normals (the layout
the renderer's builders take), and plain lists for the rest. Both the
program under test and the reference are handed these same arrays.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MATERIAL_DEFAULTS = {"base_color": [0.8, 0.8, 0.8], "metalness": 0.0, "roughness": 0.5,
                     "emissive": [0.0, 0.0, 0.0], "transmissivness": 0.0,
                     "reflectance": 0.5, "opacity": 1.0}
LIGHT_KEYS = ("point_pos", "point_color", "dir_pos", "dir_color", "spot_pos",
              "spot_color", "spot_rot", "area_pos", "area_color", "area_u", "area_v")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def _fat(verts, faces, normals=None, uvs=None):
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    corner_n = np.repeat(fn, 3, axis=0) if normals is None else normals[faces].reshape(-1, 3)
    corner_uv = (np.zeros((len(faces) * 3, 2)) if uvs is None
                 else uvs[faces].reshape(-1, 2))
    return (tri.reshape(-1, 3).astype(np.float32), corner_n.astype(np.float32),
            corner_uv.astype(np.float32), fn.astype(np.float32))


def uv_sphere(center, radius, lat, lon):
    """UV sphere with smooth vertex normals, (lat + 1) x (lon + 1) vertices."""
    cs = np.asarray(center, np.float64)
    i, j = np.meshgrid(np.arange(lat + 1), np.arange(lon + 1), indexing="ij")
    theta = np.pi * i / lat
    phi = 2 * np.pi * j / lon
    n = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  np.sin(theta) * np.sin(phi)], -1).reshape(-1, 3)
    uv = np.stack([j / lon, i / lat], -1).reshape(-1, 2)
    a = (i[:-1, :-1] * (lon + 1) + j[:-1, :-1]).reshape(-1)
    b = a + lon + 1
    faces = np.stack([np.stack([a, b, a + 1], -1), np.stack([a + 1, b, b + 1], -1)],
                     1).reshape(-1, 3)
    return _fat(cs + radius * n, faces, n, uv)


def quad(p0, p1, p2, p3):
    """Two triangles p0-p1-p2, p0-p2-p3 with face normals and corner UVs."""
    verts = np.asarray([p0, p1, p2, p3], np.float64)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    return _fat(verts, np.asarray([[0, 1, 2], [0, 2, 3]]), None, uvs)


def mesh(spec: dict):
    if spec["kind"] == "sphere":
        return uv_sphere(spec["center"], spec["radius"], spec["lat"], spec["lon"])
    if spec["kind"] == "quad":
        return quad(*spec["corners"])
    raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def scene_inputs(cfg: dict) -> dict:
    """Host arrays of a configuration: models (fat arrays + material),
    instances (model, TRS), lights (each key an (N, 3) list; absent = none),
    camera."""
    models = []
    for m in cfg["models"]:
        corners, normals, uvs, face_normals = mesh(m["mesh"])
        mat = {k: m.get(k, v) for k, v in MATERIAL_DEFAULTS.items()}
        models.append(dict(mat, corners=corners, normals=normals, uvs=uvs,
                           face_normals=face_normals))
    instances = [{"model": i["model"], "position": i.get("position", [0.0, 0.0, 0.0]),
                  "rotation": i.get("rotation", [0.0, 0.0, 0.0]),
                  "scale": i.get("scale", [1.0, 1.0, 1.0])} for i in cfg["instances"]]
    lights = {k: np.asarray(cfg["lights"].get(k, np.zeros((0, 3))), np.float32).reshape(-1, 3)
              for k in LIGHT_KEYS}
    return {"models": models, "instances": instances, "lights": lights,
            "camera": cfg["camera"]}


def triangle_count(inputs: dict) -> int:
    return sum(inputs["models"][i["model"]]["corners"].shape[0] // 3
               for i in inputs["instances"])
