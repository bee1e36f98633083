"""What the benchmark may import and load."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mvsbench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dmvsnet_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside ``mvsbench``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("mvsbench" if node.level else node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".", 1)[0])
    return names


def _sources(*parts) -> list[Path]:
    return sorted(BENCH.joinpath(*parts).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert _sources()
    for path in _sources():
        found = _imports(path) & FORBIDDEN
        assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("part", ["reference", "counts", "traffic"])
def test_the_yardstick_imports_nothing_of_the_program(part):
    for path in _sources(part):
        names = _imports(path)
        assert "dmvsnet_tpu_torch" not in names and not names & FORBIDDEN, (path, names)


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmvsnet_tpu_torch_fake", object())
    assert "dmvsnet_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_submodule", object())
    assert "jaxlib.fake_submodule" in harness.forbidden_modules()


def test_a_run_needs_the_program_beside_the_benchmark(tiny_bench):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result."""
    root, _ = tiny_bench
    code = ("from mvsbench import harness; import json; "
            "print(json.dumps(harness.run('tiny_dtu_eval', 1, 0.1, False, device='cpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
