"""What the benchmark's sources import and read: no JAX and no JAX package
anywhere (top-level names compared whole), nothing of the port in the
reference, and none of the repository's older benchmark files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from pbrt_bench import harness

SOURCES = sorted(harness.ROOT.rglob("*.py"))


def imported_tops(path: Path) -> set[str]:
    """Top-level names of ``import`` statements and of constant arguments
    of ``import_module`` calls."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((harness.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_independent_of_port(path):
    assert "physically_based_ray_tracer_tpu_torch" not in imported_tops(path)
    assert "physically_based_ray_tracer_tpu_torch" not in path.read_text()


def test_whole_name_comparison():
    """The port's name begins with the JAX package's: only whole names match."""
    import sys
    assert "physically_based_ray_tracer_tpu_torch" not in harness.FORBIDDEN
    sys.modules.setdefault("physically_based_ray_tracer_tpu_torch_probe", sys)
    try:
        assert "physically_based_ray_tracer_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("physically_based_ray_tracer_tpu_torch_probe")


def test_no_old_benchmark_files():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_", "docs/"):
            if path.parent.name == "tests" and path.name == "test_imports.py":
                continue
            assert name not in text.replace("bench.py:22", ""), (path, name)
