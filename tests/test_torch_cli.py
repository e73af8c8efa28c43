"""The port's command line on the CPU (``--cpu``): its parser is the JAX
package's, flag for flag and default for default; a demo render, an AOV
view and the post chain each write an image file at 16x16; the three tools
(``--session`` over a written asset tree with commands on stdin,
``--debug-pixel``, ``--draw-bvh``) each run and exit 0, their output
matching the JAX command line's where that is cheap (the trace's hit
prims and instances per bounce, the overlay's box count)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from physically_based_ray_tracer_tpu import cli as jcli  # noqa: E402
from physically_based_ray_tracer_tpu.scene import presets as jpresets  # noqa: E402
from physically_based_ray_tracer_tpu.utils import debug_draw as jdraw  # noqa: E402
from physically_based_ray_tracer_tpu_torch import cli  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils.image import read_image  # noqa: E402
from tests.test_torch_io import _write_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_parser_mirrors_jax():
    assert _actions(cli.build_parser()) == _actions(jcli.build_parser())


def _run(args, tmp_path, stdin=None):
    # one intra-op thread, as tests/torch_port.py sets for the test processes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "physically_based_ray_tracer_tpu_torch.cli",
                           *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300, input=stdin)


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


def _trace_hits(text):
    """(bounce, prim, inst) of each hit line of a --debug-pixel trace."""
    return re.findall(r"\[bounce (\d+)\] prim=(\d+) inst=(\d+)", text)


@pytest.mark.parametrize("tool", ["session", "debug-pixel", "draw-bvh"])
def test_cli_tools_run(tool, tmp_path, capsys):
    """Each of the JAX command line's three tools runs on the CPU and exits
    0: the session applies a move, renders, captures and quits (the JSON
    written back); the debugger prints a trace whose hit prims and
    instances equal the JAX command line's, and the colour grid; the
    overlay writes its image with as many boxes as the JAX package draws."""
    size = ["--width", "16", "--height", "16", "--cpu"]
    if tool == "session":
        root = _write_tree(tmp_path / "assets")
        cap = tmp_path / "cap.png"
        res = _run(["--session", "--assets", str(root), "--bounces", "1", "--no-aa", *size],
                   tmp_path, stdin=f"move BallA 0.5 0.2 0\nbogus\nrender\ncapture {cap}\n"
                                   "watch\nquit\n")
        assert res.returncode == 0, res.stderr
        assert f"wrote {cap}" in res.stdout and cap.stat().st_size > 0
        assert "rendered:" in res.stderr and "unknown command: bogus" in res.stderr
        assert "changed: ['" in res.stderr
        d = json.loads((root / "scene1" / "BallA.json").read_text())
        assert (d["positionX"], d["positionY"]) == (0.5, 0.2)
        res = _run(["--session", *size], tmp_path)
        assert res.returncode == 2 and "--session requires --assets" in res.stderr
    elif tool == "debug-pixel":
        args = ["--demo", "sphere", "--debug-pixel", "8", "9", "--bounces", "1", *size]
        res = _run(args, tmp_path)
        assert res.returncode == 0, res.stderr
        assert "final radiance" in res.stdout and "colour grid around (8,9)" in res.stdout
        jcli.main(args)
        want = capsys.readouterr().out
        assert _trace_hits(res.stdout) == _trace_hits(want) != []
    else:
        out = tmp_path / "bvh.png"
        res = _run(["--demo", "sphere", "--draw-bvh", "2", "--spp", "1", "--out", str(out),
                    *size], tmp_path)
        assert res.returncode == 0, res.stderr
        n = int(re.search(r"with BVH level-2 overlay \((\d+) boxes\)", res.stdout).group(1))
        jscene, _ = jpresets.sphere_demo()
        jlo, _ = jdraw.bvh_level_boxes(jscene.bvh.nodes_box, jscene.bvh.nodes_child, 2)
        assert n == jlo.shape[0] > 2
        assert read_image(str(out)).shape[:2] == (16, 16)
