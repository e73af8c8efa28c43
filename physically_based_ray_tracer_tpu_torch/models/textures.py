"""Texture decode to packed uint32 ARGB rasters; counterpart of
``physically_based_ray_tracer_tpu/models/textures.py``, a line-for-line numpy
copy. Rasters are (H, W) uint32 with 0xAARRGGBB layout, the format
``scene/material.py`` decodes. Image files and glTF-embedded images are
decoded with PIL, imported only when an image is loaded, as in the JAX
package: without PIL a textured asset cannot load.
"""

from __future__ import annotations

import os

import numpy as np


def pack_rgba_u32(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3|4) uint8 -> (H, W) uint32 ARGB."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    a = (rgb[..., 3].astype(np.uint32) if rgb.shape[-1] == 4
         else np.full(rgb.shape[:2], 255, np.uint32))
    return ((a << 24) | (rgb[..., 0].astype(np.uint32) << 16)
            | (rgb[..., 1].astype(np.uint32) << 8) | rgb[..., 2].astype(np.uint32))


def load_texture(path: str) -> np.ndarray | None:
    """Load an image file to a packed uint32 raster; None if missing."""
    if not path or not os.path.exists(path):
        return None
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA")
    return pack_rgba_u32(np.asarray(img))


def decode_image_bytes(data: bytes) -> np.ndarray | None:
    """Decode an in-memory (glTF buffer-view) image to a packed raster."""
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA")
    return pack_rgba_u32(np.asarray(img))


def combine_rma(roughness: np.ndarray | None, metalness: np.ndarray | None,
                ao: np.ndarray | None = None) -> np.ndarray | None:
    """Build an RMA raster (G = roughness, B = metalness, R = AO) from
    separate maps — the channel convention of Core/Scene.cpp:179-180."""
    ref = next((t for t in (roughness, metalness, ao) if t is not None), None)
    if ref is None:
        return None
    h, w = ref.shape
    out = np.zeros((h, w), np.uint32) | (0xFF << 24)
    if ao is not None:
        out |= ((ao >> 16) & 0xFF) << 16
    if roughness is not None:
        out |= ((roughness >> 8) & 0xFF) << 8   # take its G channel
    if metalness is not None:
        out |= metalness & 0xFF                 # take its B channel
    return out


def constant_texture(rgb, size: int = 1) -> np.ndarray:
    """Solid-color raster (testing helper)."""
    c = np.clip(np.asarray(rgb, np.float64) * 255.0, 0, 255).astype(np.uint32)
    texel = (np.uint32(0xFF) << 24) | (c[0] << 16) | (c[1] << 8) | c[2]
    return np.full((size, size), texel, np.uint32)
