"""Film: accumulation buffer with the depth-keyed reset; counterpart of
``physically_based_ray_tracer_tpu/render/film.py``.

Gamma (sqrt) is applied to the frame's trace result before accumulation; a
pixel's running mean resets when its primary-hit distance changes by more
than EPSILON. While the program's spans record, ``update`` counts the slots
whose running mean restarted (``profiling.count_reset``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physically_based_ray_tracer_tpu_torch.config import EPSILON, RenderConfig
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.profiling import count_reset


class FilmState(NamedTuple):
    accum: torch.Tensor    # (Npix, 3) accumulated (post-gamma) color
    spp: torch.Tensor      # (Npix,) samples in the running mean
    dist: torch.Tensor     # (Npix,) last primary-hit distance

    @staticmethod
    def zeros(n_pixels: int, device=DEFAULT_DEVICE) -> "FilmState":
        device = resolve(device)
        return FilmState(
            accum=torch.zeros((n_pixels, 3), dtype=torch.float32, device=device),
            spp=torch.zeros((n_pixels,), dtype=torch.float32, device=device),
            dist=torch.full((n_pixels,), -1.0, dtype=torch.float32, device=device))


def update(film: FilmState, color: torch.Tensor, primary_t: torch.Tensor,
           cfg: RenderConfig, depth_keyed: bool | None = None):
    """Accumulate one frame; returns (new_film, average_color)."""
    if depth_keyed is None:
        depth_keyed = cfg.depth_keyed_accum
    if cfg.gamma_corrected:
        pos = color > 0.0
        color = torch.where(pos, torch.sqrt(torch.where(pos, color, 1.0)),
                            torch.zeros_like(color))
    if not cfg.accumulate:
        count_reset(film.spp.shape[0])
        return FilmState(accum=color, spp=torch.ones_like(film.spp),
                         dist=primary_t), color
    if depth_keyed:
        same = torch.abs(film.dist - primary_t) < EPSILON
    else:
        same = torch.ones_like(film.spp, dtype=torch.bool)
    count_reset(film.spp.shape[0], same)
    new_spp = torch.where(same, film.spp + 1.0, torch.ones_like(film.spp))
    new_accum = torch.where(same[:, None], film.accum + color, color)
    avg = new_accum / new_spp[:, None]
    return FilmState(accum=new_accum, spp=new_spp, dist=primary_t), avg
