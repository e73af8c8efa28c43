"""Keyed texture cache; counterpart of
``physically_based_ray_tracer_tpu/models/resources.py``, a line-for-line copy.
"""

from __future__ import annotations

import enum
import os

import numpy as np

from physically_based_ray_tracer_tpu_torch.models import textures as tex


class TextureType(enum.Enum):
    ALBEDO = "albedo"
    NORMAL = "normal"
    METALNESS = "metalness"   # the RMA raster, reference naming
    ROUGHNESS = "roughness"
    EMISSION = "emission"
    AO = "ao"


class ResourceManager:
    """Keyed texture cache; `get_surface(name, type)` mirrors
    ResourceManager::getSurface (Core/ResourceManager.cpp:18-52)."""

    def __init__(self, search_dirs: list[str] | None = None,
                 texture_ext: str = ".png"):
        self.search_dirs = search_dirs or []
        self.texture_ext = texture_ext
        self._cache: dict[tuple[str, TextureType], np.ndarray | None] = {}

    def get_surface(self, name: str, kind: TextureType) -> np.ndarray | None:
        key = (name, kind)
        if key not in self._cache:
            raster = None
            for d in self.search_dirs:
                p = os.path.join(d, f"{name}_{kind.value}{self.texture_ext}")
                raster = tex.load_texture(p)
                if raster is not None:
                    break
            self._cache[key] = raster
        return self._cache[key]

    def clear(self):
        self._cache.clear()
