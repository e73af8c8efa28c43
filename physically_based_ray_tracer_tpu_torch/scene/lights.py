"""Light sets as SoA tensors; counterpart of ``physically_based_ray_tracer_tpu/scene/lights.py``.

Point lights (color * cos / dist falloff), a directional light evaluated
toward a position, a spot light with a hard dot(L, rot) > 0.9 cone, and
rectangular area lights. Counts are the tensors' leading sizes.
``lights_from_reference_json`` reads the reference's light JSON directories.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


@dataclasses.dataclass(frozen=True)
class LightSet:
    """All scene lights; counts are static (tensor shapes)."""

    point_pos: torch.Tensor     # (NP, 3)
    point_color: torch.Tensor   # (NP, 3)
    point_active: torch.Tensor  # (NP,) f32 0/1
    dir_pos: torch.Tensor       # (ND, 3) a position, as in the reference
    dir_color: torch.Tensor     # (ND, 3)
    spot_pos: torch.Tensor      # (NS, 3)
    spot_color: torch.Tensor    # (NS, 3)
    spot_rot: torch.Tensor      # (NS, 3) cone axis
    area_pos: torch.Tensor      # (NA, 3) rectangle center
    area_color: torch.Tensor    # (NA, 3) radiance
    area_u: torch.Tensor        # (NA, 3) half-edge vector 1
    area_v: torch.Tensor        # (NA, 3) half-edge vector 2

    @staticmethod
    def make(point_pos=None, point_color=None, point_active=None,
             dir_pos=None, dir_color=None,
             spot_pos=None, spot_color=None, spot_rot=None,
             area_pos=None, area_color=None, area_u=None, area_v=None,
             device=DEFAULT_DEVICE) -> "LightSet":
        device = resolve(device)

        def arr(x):
            if x is None:
                return torch.zeros((0, 3), dtype=torch.float32, device=device)
            return torch.tensor(np.asarray(x, np.float32),
                                device=device).reshape(-1, 3)

        pp = arr(point_pos)
        pa = (torch.ones((pp.shape[0],), dtype=torch.float32, device=device)
              if point_active is None
              else torch.tensor(np.asarray(point_active, np.float32),
                                device=device).reshape(-1))
        return LightSet(
            point_pos=pp, point_color=arr(point_color), point_active=pa,
            dir_pos=arr(dir_pos), dir_color=arr(dir_color),
            spot_pos=arr(spot_pos), spot_color=arr(spot_color),
            spot_rot=arr(spot_rot),
            area_pos=arr(area_pos), area_color=arr(area_color),
            area_u=arr(area_u), area_v=arr(area_v))

    def to(self, device) -> "LightSet":
        return LightSet(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    @property
    def n_point(self) -> int:
        return self.point_pos.shape[0]

    @property
    def n_dir(self) -> int:
        return self.dir_pos.shape[0]

    @property
    def n_spot(self) -> int:
        return self.spot_pos.shape[0]

    @property
    def n_area(self) -> int:
        return self.area_pos.shape[0]

    def pad_points(self, n: int = 4) -> "LightSet":
        """Pad point lights to ``n`` slots with inactive zero lights."""
        k = self.point_pos.shape[0]
        if k >= n:
            return self
        z3 = self.point_pos.new_zeros((n - k, 3))
        return dataclasses.replace(
            self,
            point_pos=torch.cat([self.point_pos, z3]),
            point_color=torch.cat([self.point_color, z3]),
            point_active=torch.cat([self.point_active,
                                    self.point_active.new_zeros((n - k,))]))


def sample_area_rect(lights: LightSet, idx: torch.Tensor, u2: torch.Tensor):
    """Uniform point on rectangular area light ``idx``; returns (point, normal, pdf_area)."""
    idx = idx.clamp(0, lights.n_area - 1)
    pos = lights.area_pos[idx]
    eu = lights.area_u[idx]
    ev = lights.area_v[idx]
    p = pos + (2.0 * u2[..., 0:1] - 1.0) * eu + (2.0 * u2[..., 1:2] - 1.0) * ev
    n = torch.linalg.cross(eu, ev, dim=-1)
    area = 4.0 * torch.linalg.norm(n, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-20)
    pdf = 1.0 / torch.clamp(area, min=1e-20)
    return p, n, pdf


def lights_from_reference_json(scene_dir: str, device=DEFAULT_DEVICE) -> LightSet:
    """Assemble a LightSet on ``device`` from reference-format JSON
    directories (``{pointlights,directionallights,spotlights,arealights}/``
    of a scene directory, files in sorted order): position ``pX..pZ``,
    colour ``cX..cZ``, spot axis ``rX..rZ``; area lights get unit half-edges
    along x and z."""

    def read_dir(sub):
        d = os.path.join(scene_dir, sub)
        out = []
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.endswith(".json"):
                    with open(os.path.join(d, f)) as fh:
                        out.append(json.load(fh))
        return out

    def pcr(rec, k1, k2, k3):
        return [rec.get(k1, 0.0), rec.get(k2, 0.0), rec.get(k3, 0.0)]

    points = read_dir("pointlights")
    dirs = read_dir("directionallights")
    spots = read_dir("spotlights")
    areas = read_dir("arealights")

    def stack(recs, keys):
        if not recs:
            return None
        return np.asarray([pcr(r, *keys) for r in recs], np.float32)

    return LightSet.make(
        point_pos=stack(points, ("pX", "pY", "pZ")),
        point_color=stack(points, ("cX", "cY", "cZ")),
        dir_pos=stack(dirs, ("pX", "pY", "pZ")),
        dir_color=stack(dirs, ("cX", "cY", "cZ")),
        spot_pos=stack(spots, ("pX", "pY", "pZ")),
        spot_color=stack(spots, ("cX", "cY", "cZ")),
        spot_rot=stack(spots, ("rX", "rY", "rZ")),
        area_pos=stack(areas, ("pX", "pY", "pZ")),
        area_color=stack(areas, ("cX", "cY", "cZ")),
        area_u=(np.tile([1.0, 0, 0], (len(areas), 1)).astype(np.float32) if areas else None),
        area_v=(np.tile([0, 0, 1.0], (len(areas), 1)).astype(np.float32) if areas else None),
        device=device)
