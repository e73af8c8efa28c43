"""The reference against the port at tiny sizes on the CPU, under the same
seed: each cell's check passes (the f32 frame slot for slot; the bf16
plain version forks a few lanes where B2's near ties fall, a larger share
of a tiny frame than of a full one), and the inverse step's
gradients agree with the port's autograd."""

from __future__ import annotations

import pytest

from pbrt_bench.tests.bench_fixtures import target_cache, tiny_run  # noqa: F401 (fixture)


@pytest.mark.parametrize("cell,width,height,most", [
    ("bench-f32-frames", 16, 9, 0.0),
    ("bench-bf16-frames", 16, 9, 0.05),
    ("cornell-bf16-frames", 20, 12, 0.05),
])
def test_frames_agree(cell, width, height, most):
    drv, checks, counts = tiny_run(cell, width, height, iterations=2)
    off, limit = checks["pixels_off"]
    assert off <= most <= limit
    assert counts.closest > 0 and counts.any > 0
    assert drv.ticks[-1][0] == 2          # the window's last tick is sample 2


def test_inverse_agrees(target_cache):
    drv, checks, _ = tiny_run("bench-inverse-steps", 16, 9, batch_pixels=64)
    assert len(drv.losses) == 4 and len(drv.batches) == 3
    for name, (value, limit) in checks.items():
        assert value < 0.1 * limit, name
