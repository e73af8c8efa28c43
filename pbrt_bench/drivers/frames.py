"""Progressive frames: one user in a closed loop of ``Renderer.tick(key=seed)``
calls, each frame accumulated into the film and fetched to the host.

Set-up builds the scene on the card from the benchmark's inputs, makes the
``Renderer`` and warms it up with one tick (sample 0). Each window iteration
is one tick. The check: for the warm-up tick (from the empty film) and the
window's last tick (from the film the tick was given), the reference
renders a sample of the film's slots, drawn from the seed, at the tick's
key and sample, applies the film's step to the film before the tick, and
compares the film after it and the image the tick returned, slot by slot.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_bench import port
from pbrt_bench.reference import geometry, integrator

UNIT = "frame"
# a slot is off when a film field or the returned image differs beyond these
ACCUM_TOL = 1e-4        # relative to 1 + |accum|
DIST_TOL = 1e-4         # relative to 1 + |dist|


class Driver:
    unit = UNIT

    def __init__(self, ctx):
        self.ctx = ctx
        self.mods = port.load()
        t = ctx.traffic
        self.cfg = port.render_config(self.mods, ctx.cfg, dict(t["engine"], **ctx.engine))
        self.key = ctx.seed

    def setup(self):
        scene, cam, _ = port.build_scene(self.mods, self.ctx.inputs, self.ctx.cfg["build"],
                                         self.ctx.device)
        self.renderer = self.mods["render.renderer"].Renderer(scene, cam, self.cfg,
                                                              device=self.ctx.device)
        self.iterate()
        self.ticks = [self.last]

    def iterate(self):
        """One tick; keeps its sample, the films before and after it (the
        renderer replaces its film, never writes it) and the image."""
        r = self.renderer
        before, sample = r.film, r.sample
        img = r.tick(self.key)
        self.last = (sample, before, r.film, img)

    def release(self):
        """Drop the program's scene; keep the films the check reads."""
        self.ticks.append(self.last)
        del self.renderer

    def check(self, counts: integrator.QueryCount):
        """The compared number with its limit: ``pixels_off``, the share of
        checked film slots that differ from the reference."""
        ref_scene = geometry.bake(self.ctx.inputs, self.ctx.device)
        off, total = compare_ticks(ref_scene, self.ctx.cfg["render"], self.ctx.seed, self.ticks,
                                   self.ctx.traffic["check"]["slots"], counts)
        return {"pixels_off": (off / total, self.ctx.limits["pixels_off"])}


def slot_sample(n_pixels: int, n: int, seed: int, which: int) -> np.ndarray:
    """``n`` distinct film slots, drawn from the seed (one draw per checked
    tick), sorted."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, which])
    return np.sort(rng.choice(n_pixels, size=min(n, n_pixels), replace=False))


def compare_ticks(ref_scene, render: dict, seed: int, ticks, n_slots: int, counts=None):
    """(slots off, slots checked) over ``ticks``: per tick (sample, film
    before, film after, returned image), the reference's frame at key
    ``seed`` at a sample of slots drawn from ``seed``."""
    w, h, bounces = render["width"], render["height"], render["bounces"]
    order = integrator.morton_order(w, h)
    dev = ref_scene.v0.device
    off = total = 0
    for which, (sample, before, after, img) in enumerate(ticks):
        slots_np = slot_sample(w * h, n_slots, seed, which)
        slots = torch.from_numpy(slots_np).to(dev)
        ids_np = order[slots_np]
        ids = torch.from_numpy(ids_np).to(dev)
        with torch.no_grad():
            color, t = integrator.render_sample(ref_scene, ids, seed, sample, w, h, bounces,
                                                counts)
            f = lambda x: x.to(dev)[slots].float()
            accum, spp, dist, avg = integrator.film_update(
                f(before.accum), f(before.spp), f(before.dist), color.float(), t.float())
        got = after.accum.to(dev)[slots]
        image = torch.from_numpy(np.ascontiguousarray(img.reshape(-1, 3)[ids_np])).to(dev)
        bad = (((got - accum).abs() > ACCUM_TOL * (1.0 + accum.abs())).any(-1)
               | (after.spp.to(dev)[slots] != spp)
               | ((after.dist.to(dev)[slots] - dist).abs() > DIST_TOL * (1.0 + dist.abs()))
               | ((image - torch.clamp(avg, 0.0, 1.0)).abs()
                  > ACCUM_TOL * (1.0 + avg.abs())).any(-1))
        off += int(bad.sum())
        total += bad.numel()
    return off, total
