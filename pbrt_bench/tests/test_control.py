"""The controls come out not correct: the reference in bfloat16 in the
program's place (the bf16 frame cells and the inverse cell) on the CPU at
a tiny size, and on the card at the cells' own size; the f32 cell's
control, the program's bf16 engine, on the card."""

from __future__ import annotations

import pytest
import torch

from pbrt_bench import control
from pbrt_bench.run import Context
from pbrt_bench.tests.bench_fixtures import SEED, card, target_cache  # noqa: F401 (fixtures)


@pytest.mark.parametrize("cell,width,height", [("bench-bf16-frames", 16, 9),
                                               ("cornell-bf16-frames", 20, 12)])
def test_bf16_reference_fails_frames(cell, width, height):
    ctx = Context(cell, SEED, torch.device("cpu"), render={"width": width, "height": height})
    ctx.traffic = dict(ctx.traffic, check={"slots": width * height})
    off, limit = control.control_frames(ctx)["pixels_off"]
    assert off > limit


def test_bf16_reference_fails_steps(target_cache):
    ctx = Context("bench-inverse-steps", SEED, torch.device("cpu"),
                  render={"width": 16, "height": 9})
    ctx.traffic = dict(ctx.traffic, batch_pixels=64)
    checks = control.control_steps(ctx)
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bench-bf16-frames", "cornell-bf16-frames",
                                  "bench-f32-frames", "bench-inverse-steps"])
def test_control_fails_on_card(cell, card, capsys):
    """At the cell's own size on the card, three seeds."""
    seeds = ",".join(str(SEED + k) for k in range(3))
    assert control.main(["--workload", cell, "--seeds", seeds, "--seconds", "3",
                         "--control"]) == 0
    import json
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = Context(cell, SEED, card).limits
    assert len(lines) == 3
    for line in lines:
        assert any(v > limits[k] for k, v in line["checks"].items()), line
