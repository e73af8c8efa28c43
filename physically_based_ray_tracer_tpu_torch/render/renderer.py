"""Frame orchestration; counterpart of ``physically_based_ray_tracer_tpu/render/renderer.py``.

``frame_fn`` renders one sample of a pixel subset in sequential wavefront
chunks of ``cfg.chunk_pixels`` (bounding live device memory) and folds it
into the film. ``Renderer`` owns the film on one device and returns display
images. PyTorch runs eagerly, so there is no compiled frame function.
"""

from __future__ import annotations

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.render import film as film_mod
from physically_based_ray_tracer_tpu_torch.render.integrator import (
    check_supported, render_sample)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def render_chunked(scene, cam, cfg: RenderConfig, key: int, sample: int,
                   pixel_ids: torch.Tensor):
    """render_sample over sequential chunks; returns (color (B,3), t (B,)).
    The last chunk is edge-padded to the common chunk size, as the JAX
    package pads its ``lax.map`` input."""
    b = pixel_ids.shape[0]
    if b <= cfg.chunk_pixels:
        return render_sample(scene, cam, cfg, key, sample, pixel_ids)
    n_chunks = -(-b // cfg.chunk_pixels)
    chunk = -(-b // n_chunks)
    padded = chunk * n_chunks
    ids = torch.cat([pixel_ids, pixel_ids[-1:].expand(padded - b)])
    colors, ts = [], []
    for c in range(n_chunks):
        col, t = render_sample(scene, cam, cfg, key, sample,
                               ids[c * chunk:(c + 1) * chunk])
        colors.append(col)
        ts.append(t)
    return torch.cat(colors)[:b], torch.cat(ts)[:b]


def frame_fn(scene, cam, film: film_mod.FilmState, key: int, sample: int,
             pixel_ids: torch.Tensor, *, cfg: RenderConfig):
    """One frame for a pixel subset; returns (new_film, averaged_color (B, 3))."""
    color, primary_t = render_chunked(scene, cam, cfg, key, sample, pixel_ids)
    return film_mod.update(film, color, primary_t, cfg)


def morton_pixel_order(width: int, height: int) -> np.ndarray:
    """Pixel ids in Morton (Z-curve) order."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.uint64)

    def part1by1(x):
        x &= 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    code = part1by1(xs) | (part1by1(ys) << 1)
    flat_ids = (ys * width + xs).ravel()
    order = np.argsort(code.ravel(), kind="stable")
    return flat_ids[order].astype(np.int32)


class Renderer:
    """Owns the film on ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``) and renders frames of one scene.

    Four traversal engines run: ``traversal="pallas"`` with the
    ``RenderConfig`` default ``leaf_precision="bf16"`` (kernel B2) or the
    exact ``"f32"`` one (kernel B1), the row-parallel exact engine
    ``traversal="pallas_rows"`` (kernel B3), and the wave engine
    ``traversal="wave"`` over the scene's classic BVH (the node-scan kernel
    and kernel B4), which needs a scene built with ``legacy_bvh=True``.
    Options the port does not carry, and a wave config on a scene without a
    classic BVH, are refused here at construction, before any device work
    (see ``integrator.check_supported``).

    ``key`` is the integer seed the JAX package would pass as
    ``jax.random.key(key)``; images are pixel-for-pixel comparable."""

    def __init__(self, scene, camera, config: RenderConfig,
                 device=DEFAULT_DEVICE):
        check_supported(config, scene)
        self.device = resolve(device)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.film = film_mod.FilmState.zeros(config.n_pixels, device=self.device)
        self.sample = 0
        if config.pixel_order == "morton":
            self._pixel_ids_np = morton_pixel_order(config.width, config.height)
        else:
            self._pixel_ids_np = np.arange(config.n_pixels, dtype=np.int32)
        self._pixel_ids = torch.from_numpy(self._pixel_ids_np).to(self.device)

    def reset_accumulation(self):
        self.film = film_mod.FilmState.zeros(self.config.n_pixels,
                                             device=self.device)
        self.sample = 0

    def tick(self, key: int = 0) -> np.ndarray:
        """Render one frame (1 sample/pixel [+AA]), update accumulation, and
        return the display image (H, W, 3) float in [0, 1]."""
        self.film, avg = frame_fn(self.scene, self.camera, self.film, key,
                                  self.sample, self._pixel_ids, cfg=self.config)
        self.sample += 1
        return self._assemble(avg.cpu().numpy())

    def _assemble(self, avg_flat: np.ndarray) -> np.ndarray:
        """Scatter film-order samples back into raster order."""
        img_flat = np.empty_like(avg_flat)
        img_flat[self._pixel_ids_np] = avg_flat
        img = img_flat.reshape(self.config.height, self.config.width, 3)
        return np.clip(img, 0.0, 1.0)

    def render(self, samples: int = 1, seed: int = 0) -> np.ndarray:
        """Accumulate ``samples`` frames and return the final image."""
        img = None
        for _ in range(samples):
            img = self.tick(seed)
        return img
