"""Fixtures and helpers of the benchmark's tests, imported by the test
modules that use them: tiny runs of a cell on the CPU (the port's plain
versions), and the card for the tests marked ``cuda``."""

from __future__ import annotations

import pytest
import torch

from pbrt_bench.reference.integrator import QueryCount
from pbrt_bench.run import Context

SEED = 3_000_000_007          # above 2**31, as the benchmark's seeds are


def tiny_run(cell, width, height, seed=SEED, engine=None, slots=None, iterations=1,
             **traffic):
    """Set-up, ``iterations`` window iterations and the check of ``cell`` on
    the CPU at width x height. Returns (driver, checks, query counts)."""
    ctx = Context(cell, seed, torch.device("cpu"), engine=engine,
                  render={"width": width, "height": height, "chunk_pixels": 64})
    ctx.traffic = dict(ctx.traffic, check={"slots": slots or width * height}, **traffic)
    drv = ctx.driver()
    drv.setup()
    for _ in range(iterations):
        drv.iterate()
    drv.release()
    counts = QueryCount()
    return drv, drv.check(counts), counts


@pytest.fixture
def card():
    """The CUDA device, for tests marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def target_cache(tmp_path, monkeypatch):
    """The inverse cell's target cache in a temporary directory."""
    from pbrt_bench.drivers import inverse
    monkeypatch.setattr(inverse, "CACHE", tmp_path)
    return tmp_path
