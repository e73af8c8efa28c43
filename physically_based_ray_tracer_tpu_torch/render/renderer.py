"""Frame orchestration; counterpart of ``physically_based_ray_tracer_tpu/render/renderer.py``.

``frame_fn`` renders one frame of a pixel subset (``cfg.samples_per_pixel``
in-frame samples averaged, ``_render_spp``) in sequential wavefront chunks
of ``cfg.chunk_pixels`` (bounding live device memory) and folds it into the
film. ``Renderer`` owns the film on one device, times each tick
(``stats``), returns display images (post-processed on its device when
``cfg.post_processed``) and captures them to PNG. PyTorch runs eagerly, so
there is no compiled frame function; on the card, a tick replays one chunk
recorded as a CUDA graph instead (``render/graph.py``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.ops.tonemap import POST_PRESETS, post_process
from physically_based_ray_tracer_tpu_torch.render import film as film_mod
from physically_based_ray_tracer_tpu_torch.render.graph import ChunkGraph, graph_path
from physically_based_ray_tracer_tpu_torch.render.integrator import (
    check_supported, render_sample, table_bytes)
from physically_based_ray_tracer_tpu_torch.scene.scene import rebuild_scene
from physically_based_ray_tracer_tpu_torch.utils import image as image_utils
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.profiling import (add_attrs, annotate,
                                                                   host_read)
from physically_based_ray_tracer_tpu_torch.utils.timer import (DeviceTimer, FrameStats,
                                                               ray_count)


def _render_spp(scene, cam, cfg: RenderConfig, key, sample: int,
                pixel_ids: torch.Tensor):
    """render_sample averaged over cfg.samples_per_pixel in-frame samples
    (sample index ``sample * spp + s``); the primary t is sample 0's.
    ``key``: see ``integrator.trace_paths``."""
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
    ids, n_chunks, chunk = _chunks(pixel_ids, cfg.chunk_pixels)
    colors, ts = [], []
    for c in range(n_chunks):
        col, t = _render_spp(scene, cam, cfg, key, sample,
                             ids[c * chunk:(c + 1) * chunk])
        colors.append(col)
        ts.append(t)
    return torch.cat(colors)[:b], torch.cat(ts)[:b]


def _chunks(pixel_ids: torch.Tensor, chunk_pixels: int):
    """(ids, n_chunks, chunk): ``render_chunked``'s chunks, ``n_chunks`` of
    ``chunk`` ids each, the ids edge-padded to fill them."""
    b = pixel_ids.shape[0]
    if b <= chunk_pixels:
        return pixel_ids, 1, b
    n_chunks = -(-b // chunk_pixels)
    chunk = -(-b // n_chunks)
    ids = torch.cat([pixel_ids, pixel_ids[-1:].expand(chunk * n_chunks - b)])
    return ids, n_chunks, chunk


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
    host, the display image) a ``pbrt.film`` span.

    ``handle`` is the ``InstancedScene`` that ``build_scene_instanced``
    returned with ``scene``; with it, ``tick(key, instances)`` moves the
    instances inside the tick (the game loop's pose sync and TLAS rebuild
    before the render), and the film keeps its per-pixel depth-keyed
    reset.

    A chunk runs the integrator's one full-width body, which reads nothing
    on the host (``integrator`` module docstring). Where
    ``graph.graph_path`` allows (the card, the dense engines, the shaded
    image, no resharding, no shade tiles), the first tick records one chunk
    of the frame as a CUDA graph (``graph.ChunkGraph``) and every tick
    replays it for each chunk: its images are the eager path's, bit for
    bit. A new scene or camera of the same layout (``tick``'s moved
    instances, an edited light or camera) is copied into the recording's
    inputs; another layout or another ``config`` is recorded anew. The
    ``pbrt.tick`` span's attributes count ``chunks``, ``replays`` (the
    chunks replayed), ``captures`` (1 where the tick recorded) and
    ``refreshed`` (the tensors copied in)."""

    def __init__(self, scene, camera, config: RenderConfig,
                 device=DEFAULT_DEVICE, handle=None):
        check_supported(config, scene)
        self.device = resolve(device)
        self.scene = scene.to(self.device)
        self.handle = handle
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
        self._graph = None

    def reset_accumulation(self):
        self.film = film_mod.FilmState.zeros(self.config.n_pixels,
                                             device=self.device)
        self.sample = 0

    def tick(self, key: int = 0, instances=None) -> np.ndarray:
        """Render one frame (``samples_per_pixel`` samples/pixel [+AA]),
        update accumulation, and return the display image (H, W, 3) float
        in [0, 1].

        ``instances`` (the scene's instance list at this tick's poses)
        first moves the scene: ``rebuild_scene`` in a ``pbrt.rebuild`` span
        (attributes ``moved`` and ``tris``, the instances and triangles
        re-baked), inside the tick's time. The film is not reset: each
        pixel's running mean restarts where its primary-hit distance
        moved. Without ``instances`` the tick does nothing more."""
        if instances is not None and self.handle is None:
            raise ValueError("Renderer.tick: instances need the InstancedScene handle "
                             "of build_scene_instanced (Renderer(..., handle=))")
        with annotate("pbrt.tick"), contextlib.ExitStack() as timed:
            timer = timed.enter_context(DeviceTimer(self.device))
            if instances is not None:
                with annotate("pbrt.rebuild"):
                    self.scene = rebuild_scene(self.scene, self.handle, instances,
                                               device=self.device)
            color, primary_t = self._render(key)
            with annotate("pbrt.film"):
                self.film, avg = film_mod.update(self.film, color, primary_t, self.config)
                avg = host_read("film_fetch", avg)
                timed.close()           # the tick's time ends with the fetch
                self.sample += 1
                self.stats.update(timer.ms, ray_count(
                    self.config, self.config.n_pixels,
                    n_point_lights=self.scene.lights.n_point))
                return self._assemble(avg)

    def _render(self, key: int):
        """The frame's (color, primary t): the recorded chunk replayed where
        ``graph_path`` allows (recorded first where there is no recording
        that takes this scene, camera and config), else ``render_chunked``;
        the counts, and the bytes of the tables the traversal reads, go to
        the tick's span."""
        cfg, b = self.config, self._pixel_ids.shape[0]
        add_attrs(table_bytes=table_bytes(self.scene, cfg))
        if not graph_path(cfg, self.device):
            self._graph = None
            add_attrs(chunks=-(-b // cfg.chunk_pixels), replays=0, captures=0, refreshed=0)
            return render_chunked(self.scene, self.camera, cfg, key, self.sample,
                                  self._pixel_ids)
        g, captures, refreshed = self._graph, 0, 0
        if g is not None and g.accepts(self.scene, self.camera, cfg):
            refreshed = g.refresh(self.scene, self.camera)
        else:
            self._graph = None          # the old recording's memory goes first
            g = self._graph = ChunkGraph(_render_spp, self.scene, self.camera, cfg,
                                         *_chunks(self._pixel_ids, cfg.chunk_pixels), b,
                                         self.device)
            g.capture()
            captures = 1
        out = g.run(key, self.sample)
        add_attrs(chunks=g.n_chunks, replays=0 if g.graph is None else g.n_chunks,
                  captures=captures, refreshed=refreshed)
        return out

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
