"""The port's scaling harness (``parallel/scaling.py``), profiling helpers
(``utils/profiling.py``) and dry run (``dryrun.py``) on the CPU.

tests/test_scaling.py's check on the port: ``measure_scaling`` over 1, 2
and 4 gloo ranks gives a row per rank count, positive times and rates, and
an efficiency of exactly 1.0 at one rank (times on ranks that share the
host's cores say nothing about scaling). ``measure_work_invariance`` gives
a row per divisor. ``trace`` writes a Chrome trace that names an
``annotate`` span; ``stopwatch`` reports its label in ms; ``python -m
physically_based_ray_tracer_tpu_torch.dryrun --ranks 2 --cpu`` exits 0."""

import json
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from physically_based_ray_tracer_tpu_torch.parallel.mesh import spawn_ranks  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel.scaling import (  # noqa: E402
    measure_work_invariance)
from physically_based_ray_tracer_tpu_torch.utils.profiling import (TRACE_FILE, annotate,  # noqa: E402
                                                                   stopwatch, trace)
from tests import torch_ranks  # noqa: E402
from tests.scenes import TINY, sphere_scene  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_tiny():
    jscene, jcam = sphere_scene()
    return port_scene(jscene), port_camera(jcam), port_config(TINY)


def test_measure_scaling_runs(port_tiny):
    scene, cam, cfg = port_tiny
    out = spawn_ranks(torch_ranks.scaling, 4, args=(4, scene, cam, cfg, [1, 2, 4]),
                      timeout=300)
    rows = out[0]
    assert all(o is None for o in out[1:])
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["ms"] > 0 and r["mrays_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0


def test_measure_work_invariance_runs(port_tiny):
    scene, cam, cfg = port_tiny
    rows = measure_work_invariance(scene, cam, cfg, divisors=(1, 2, 4), iters=1)
    assert [r["divisor"] for r in rows] == [1, 2, 4]
    assert rows[0]["normalized_cost"] == 1.0
    assert all(r["ms"] > 0 and r["normalized_cost"] > 0 for r in rows)


def test_trace_names_an_annotated_span(tmp_path):
    with trace(str(tmp_path)) as log_dir:
        with annotate("pbrt_span"):
            torch.ones(64).cumsum(0)
    assert log_dir == str(tmp_path)
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pbrt_span" for e in events)


def test_stopwatch_reports_ms():
    lines = []
    with stopwatch("frame", sink=lines.append):
        torch.ones(8).sum()
    assert len(lines) == 1 and lines[0].startswith("frame: ") and lines[0].endswith(" ms")
    assert float(lines[0].split()[1]) >= 0.0


def test_dryrun_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", "physically_based_ray_tracer_tpu_torch.dryrun",
                        "--ranks", "2", "--cpu"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "dryrun(2 ranks, cpu)" in p.stdout
