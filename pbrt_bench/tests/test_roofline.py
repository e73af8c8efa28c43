"""The query count and the bytes of ``traversal_roofline_pct.frame``."""

from __future__ import annotations

import pytest
import torch

from pbrt_bench import harness, scenes
from pbrt_bench.reference import geometry, integrator
from pbrt_bench.run import Context

roofline = harness.load_module("metrics", "traversal_roofline_pct.frame")


@pytest.mark.parametrize("cell", ["bench-bf16-frames", "cornell-bf16-frames"])
def test_count_is_the_live_lanes_traced(cell, monkeypatch):
    """The counted queries equal the lanes the reference's intersection
    was asked to trace (positive range)."""
    ctx = Context(cell, 11, torch.device("cpu"), render={"width": 12, "height": 8})
    scene = geometry.bake(ctx.inputs, "cpu")
    traced = {"closest": 0, "any": 0}
    real = integrator.intersect

    def spy(s, o, d, t_max, closest):
        traced["closest" if closest else "any"] += int((t_max > 0).sum())
        return real(s, o, d, t_max, closest)
    monkeypatch.setattr(integrator, "intersect", spy)
    counts = integrator.QueryCount()
    ids = torch.arange(96)
    integrator.render_sample(scene, ids, 11, 0, 12, 8, 4, counts)
    assert (counts.closest, counts.any) == (traced["closest"], traced["any"])
    assert counts.closest >= 2 * 96          # every lane traces its first bounce


@pytest.mark.parametrize("cell", ["bench-bf16-frames", "cornell-bf16-frames"])
def test_least_time_under_the_kernels(cell):
    """At the most queries a frame can trace (every lane live at every
    bounce, one shadow ray each), the least time is far under the ~8 ms of
    B1 and B2 a bench frame takes, so the share reads under 100%."""
    ctx = Context(cell, 11, torch.device("cpu"))
    render = ctx.cfg["render"]
    most = {"closest_per_pixel": 2.0 * render["bounces"], "any_per_pixel": 2.0 * render["bounces"],
            "triangles": scenes.triangle_count(ctx.inputs)}
    least_s = roofline.frame_bytes(render, most) / harness.PEAK_HBM_BYTES_PER_S
    assert 0 < least_s < 1e-3


def test_share_reads_nothing_without_a_trace():
    class R:
        trace = None
        counted = {"closest_per_pixel": 1.0, "any_per_pixel": 1.0, "triangles": 1}
    assert roofline.read(R()) is None
