"""The run's entry and its last line."""

from __future__ import annotations

import json

import pytest
import torch

from pbrt_bench import harness, run


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the run fails and prints no result: nothing is
    measured on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "bench-bf16-frames", "--seed", "5", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "nothing is measured on the CPU" in out.err


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    w = harness.Window("frame")
    w.durations = [1.0, 1.1]
    w.seconds = 2.1
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1}
    breakdown = {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::nonzero", 0.01]]}
    line = harness.result_line(True, w, {"frame_ms": {"value": 1.0, "unit": "ms"}}, device,
                               {"pixels_off": (0.001, 0.01)}, breakdown if traced else None)
    out = json.loads(line)
    keys = list(out)
    assert keys[:5] == list(harness.RESULT_KEYS)
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == traced
    assert len(keys) == 7 if traced else 6
    assert out["checks"]["pixels_off"] == {"value": 0.001, "limit": 0.01}
    assert out["attempted"] == 2 and out["failed"] == 0


def test_percentile():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    assert harness.percentile([7.0], 95) == 7.0
