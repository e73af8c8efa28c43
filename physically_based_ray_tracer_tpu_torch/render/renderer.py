"""Frame orchestration; counterpart of ``physically_based_ray_tracer_tpu/render/renderer.py``.

``frame_fn`` renders one frame of a pixel subset (``cfg.samples_per_pixel``
in-frame samples averaged, ``_render_spp``) in sequential wavefront chunks
of ``cfg.chunk_pixels`` (bounding live device memory) and folds it into the
film. ``Renderer`` owns the film on one device, times each tick
(``stats``), returns display images (post-processed on its device when
``cfg.post_processed``) and captures them to PNG. PyTorch runs eagerly, so
there is no compiled frame function.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.ops.tonemap import POST_PRESETS, post_process
from physically_based_ray_tracer_tpu_torch.render import film as film_mod
from physically_based_ray_tracer_tpu_torch.render.integrator import (
    check_supported, render_sample)
from physically_based_ray_tracer_tpu_torch.utils import image as image_utils
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.profiling import annotate, host_read
from physically_based_ray_tracer_tpu_torch.utils.timer import (DeviceTimer, FrameStats,
                                                               ray_count)


def _render_spp(scene, cam, cfg: RenderConfig, key: int, sample: int,
                pixel_ids: torch.Tensor):
    """render_sample averaged over cfg.samples_per_pixel in-frame samples
    (sample index ``sample * spp + s``); the primary t is sample 0's."""
    spp = max(1, cfg.samples_per_pixel)
    if spp == 1:
        return render_sample(scene, cam, cfg, key, sample, pixel_ids)
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                      device=pixel_ids.device)
    t0 = None
    for s in range(spp):
        c, t = render_sample(scene, cam, cfg, key, sample * spp + s, pixel_ids)
        acc = acc + c
        if s == 0:
            t0 = t
    return acc / spp, t0


def render_chunked(scene, cam, cfg: RenderConfig, key: int, sample: int,
                   pixel_ids: torch.Tensor):
    """_render_spp over sequential chunks; returns (color (B,3), t (B,)).
    The last chunk is edge-padded to the common chunk size, as the JAX
    package pads its ``lax.map`` input."""
    b = pixel_ids.shape[0]
    if b <= cfg.chunk_pixels:
        return _render_spp(scene, cam, cfg, key, sample, pixel_ids)
    n_chunks = -(-b // cfg.chunk_pixels)
    chunk = -(-b // n_chunks)
    padded = chunk * n_chunks
    ids = torch.cat([pixel_ids, pixel_ids[-1:].expand(padded - b)])
    colors, ts = [], []
    for c in range(n_chunks):
        col, t = _render_spp(scene, cam, cfg, key, sample,
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

    Six traversal engines run: ``traversal="pallas"`` with the
    ``RenderConfig`` default ``leaf_precision="bf16"`` (kernel B2) or the
    exact ``"f32"`` one (kernel B1), the row-parallel exact engine
    ``traversal="pallas_rows"`` (kernel B3), and three engines over the
    scene's classic BVH, which need a scene built with ``legacy_bvh=True``:
    the wave engine ``traversal="wave"`` (the fused level kernel) and the
    torch engines ``"packet"`` and ``"lane"``. Options the port does not
    carry, and a classic-BVH engine on a scene without that BVH, are refused
    here at construction, before any device work (see
    ``integrator.check_supported``).

    ``key`` is the integer seed the JAX package would pass as
    ``jax.random.key(key)``; images are pixel-for-pixel comparable.
    ``stats`` holds the last tick's time (``DeviceTimer``: the device's
    queue drained at both ends, the film fetched to the host inside) and
    its ray count (``utils.timer.ray_count``). A tick is a ``pbrt.tick``
    span; its tail after the last chunk (the film's update, the fetch to the
    host, the display image) a ``pbrt.film`` span."""

    def __init__(self, scene, camera, config: RenderConfig,
                 device=DEFAULT_DEVICE):
        check_supported(config, scene)
        self.device = resolve(device)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.film = film_mod.FilmState.zeros(config.n_pixels, device=self.device)
        self.stats = FrameStats()
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
        """Render one frame (``samples_per_pixel`` samples/pixel [+AA]),
        update accumulation, and return the display image (H, W, 3) float
        in [0, 1]."""
        with annotate("pbrt.tick"), contextlib.ExitStack() as timed:
            timer = timed.enter_context(DeviceTimer(self.device))
            color, primary_t = render_chunked(self.scene, self.camera, self.config, key,
                                              self.sample, self._pixel_ids)
            with annotate("pbrt.film"):
                self.film, avg = film_mod.update(self.film, color, primary_t, self.config)
                avg = host_read("film_fetch", avg)
                timed.close()           # the tick's time ends with the fetch
                self.sample += 1
                self.stats.update(timer.ms, ray_count(
                    self.config, self.config.n_pixels,
                    n_point_lights=self.scene.lights.n_point))
                return self._assemble(avg)

    def _assemble(self, avg_flat: np.ndarray) -> np.ndarray:
        """Scatter film-order samples back into raster order, post-process
        (on the Renderer's device) when ``post_processed``, clip to [0, 1]."""
        img_flat = np.empty_like(avg_flat)
        img_flat[self._pixel_ids_np] = avg_flat
        img = img_flat.reshape(self.config.height, self.config.width, 3)
        if self.config.post_processed:
            pp = POST_PRESETS.get(self.config.post_preset, POST_PRESETS[2])
            img = host_read("post_fetch", post_process(
                torch.from_numpy(img).to(self.device),
                aberration_intensity=pp["aberration_intensity"],
                vignette_intensity=pp["vignette_intensity"],
                vignette_radius=pp["vignette_radius"],
                grading=pp["grading"]))
        return np.clip(img, 0.0, 1.0)

    def render(self, samples: int = 1, seed: int = 0) -> np.ndarray:
        """Accumulate ``samples`` frames and return the final image."""
        img = None
        for _ in range(samples):
            img = self.tick(seed)
        return img

    def capture(self, path: str | None = None) -> str:
        """Write the current image as PNG (one frame rendered first if none
        has been); returns the path. ``path`` defaults to a timestamped
        name under ``assets/captures`` (``utils.image.capture_path``)."""
        img = self.render(samples=1) if self.sample == 0 else self._current_image()
        path = path or image_utils.capture_path()
        return image_utils.write_png(path, img)

    def _current_image(self) -> np.ndarray:
        """The film's running mean as a display image."""
        avg = self.film.accum.cpu().numpy() / np.maximum(
            self.film.spp.cpu().numpy()[:, None], 1.0)
        return self._assemble(avg)
