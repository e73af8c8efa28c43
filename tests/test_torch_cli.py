"""The port's command line on the CPU (``--cpu``): its parser is the JAX
package's, flag for flag and default for default; a demo render, an AOV
view and the post chain each write an image file at 16x16; the three tools
that are not ported exit non-zero, naming themselves, before any work."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from physically_based_ray_tracer_tpu import cli as jcli  # noqa: E402
from physically_based_ray_tracer_tpu_torch import cli  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils.image import read_image  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_parser_mirrors_jax():
    assert _actions(cli.build_parser()) == _actions(jcli.build_parser())


def _run(args, tmp_path):
    # one intra-op thread, as tests/torch_port.py sets for the test processes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "physically_based_ray_tracer_tpu_torch.cli",
                           *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [
    ["--demo", "sphere", "--spp", "2"],
    ["--demo", "cornell", "--aov", "DEPTH", "--spp", "1"],
    ["--demo", "cornell", "--post", "--post-preset", "1", "--spp", "1", "--bounces", "1"],
], ids=["sphere", "aov-depth", "post"])
def test_cli_writes_an_image(args, tmp_path):
    out = tmp_path / "out" / "img.png"
    res = _run([*args, "--width", "16", "--height", "16", "--cpu", "--out", str(out)],
               tmp_path)
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}" in res.stdout
    assert res.stderr.count("Mrays/s") == int(args[args.index("--spp") + 1])
    img = read_image(str(out))
    assert img.shape[:2] == (16, 16) and img[..., :3].max() > 0.0


def test_cli_main_in_process(tmp_path):
    """main() returns 0 and writes the capture (the AOV view of BASECOLOR
    without AA or gamma)."""
    out = tmp_path / "b.png"
    assert cli.main(["--demo", "sphere", "--aov", "BASECOLOR", "--no-aa", "--no-gamma",
                     "--width", "8", "--height", "8", "--spp", "1", "--cpu",
                     "--out", str(out)]) == 0
    img = read_image(str(out))[..., :3]
    assert np.isfinite(img).all() and img.max() > 0.1


@pytest.mark.parametrize("args,name", [
    (["--session"], "--session"),
    (["--debug-pixel", "3", "4"], "--debug-pixel"),
    (["--draw-bvh", "2"], "--draw-bvh"),
])
def test_cli_unported_tools_exit_nonzero(args, name, tmp_path):
    res = _run([*args, "--cpu"], tmp_path)
    assert res.returncode != 0
    assert name in res.stderr and "not ported" in res.stderr
    assert "wrote" not in res.stdout and not list(tmp_path.iterdir())
