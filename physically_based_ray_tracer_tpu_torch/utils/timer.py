"""Timing + throughput accounting; counterpart of ``physically_based_ray_tracer_tpu/utils/timer.py``.

Rays/s is computed from the traced ray count (primary + AA + shadow + bounce
lanes), not the reference's pixels/ms readout. ``DeviceTimer`` times device
work to completion: on a CUDA device it waits for that device to finish
before reading the host clock; on the CPU, where PyTorch runs eagerly, the
host clock alone is the time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from physically_based_ray_tracer_tpu_torch.config import P_POINT


@dataclass
class FrameStats:
    frame_ms: float = 0.0
    rays: int = 0
    ema_ms: float = 10.0       # the EMA start of the reference's perf readout
    alpha: float = 1.0

    @property
    def fps(self) -> float:
        return 1000.0 / max(self.ema_ms, 1e-9)

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.frame_ms, 1e-9) / 1e3

    def update(self, frame_ms: float, rays: int):
        self.frame_ms = frame_ms
        self.rays = rays
        self.ema_ms = (1 - self.alpha) * self.ema_ms + self.alpha * frame_ms
        if self.alpha > 0.05:
            self.alpha *= 0.5


def ray_count(config, n_pixels: int, spp: int = 1,
              n_point_lights: int = 4) -> int:
    """Lane-slot count per frame: per path vertex (per AA sub-path, per
    bounce) one closest-hit extension lane (an upper bound on live
    extension rays: lanes of dead paths count too) plus the NEE shadow
    lanes: ``n_point_lights`` with probability P_POINT and 1 otherwise for
    the stochastic all-lights estimator, exactly 1 with ``one_shadow_ray``
    or non-stochastic lights, none when unlit."""
    paths = n_pixels * spp * (2 if config.antialias else 1)
    vertices = paths * config.bounces
    if not config.lighted:
        shadow = 0.0
    elif config.stochastic_lights and not config.one_shadow_ray:
        shadow = vertices * (P_POINT * n_point_lights + (1.0 - P_POINT))
    else:
        shadow = float(vertices)
    return int(vertices + shadow)


def live_ray_count(config, n_pixels: int, ext_fractions, shadow_fractions,
                   spp: int = 1) -> int:
    """Expected rays traced per frame from measured per-bounce live-lane
    fractions: ``ext_fractions[b]`` of lanes trace a bounce-``b`` extension
    ray, ``shadow_fractions[b]`` a live NEE shadow ray."""
    lanes = n_pixels * spp * (2 if config.antialias else 1)
    ext = sum(ext_fractions)
    shadow = sum(shadow_fractions) if config.lighted else 0.0
    return int(lanes * (ext + shadow))


def _sync(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DeviceTimer:
    """Context manager timing the work queued on ``device`` to completion
    (host clock, with the device's queue drained at both ends)."""

    def __init__(self, device="cpu"):
        self.device = device
        self.ms = 0.0

    def __enter__(self):
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def _wait(out) -> None:
    """Drain the devices of the tensors in ``out`` (a tensor or a nested
    tuple / list of them)."""
    if isinstance(out, torch.Tensor):
        _sync(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _wait(x)


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall ms of ``fn(*args)``, each call waited to completion."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]
