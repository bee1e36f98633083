"""Fixtures of the benchmark's own tests (run them from the checkout's root:
``python -m pytest mvsbench/tests -o addopts="" -p no:cacheprovider``; the
repository's ``tests/`` suite does not collect them).  On the card:
``... -m cuda``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY = dict(height=64, width=96, views=3)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder and ``BENCHMARK.json`` in a temporary
    checkout root, with a ``tiny`` configuration (8/8/8 planes) and, for each
    workload file ``<c>``, a cell ``tiny_<c>`` at 64x96 and 3 views that
    keeps the cell's batch, traffic and limits; ``BENCHMARK.json``'s metrics
    list the tiny cells of the cells it has.  Returns (root, benchmark
    folder)."""
    bench = tmp_path / "mvsbench"
    shutil.copytree(REPO / "mvsbench", bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for name in ("dmvsnet_dtu", "dmvsnet_tank"):
        cfg = json.loads((bench / "configs" / f"{name}.json").read_text())
        cfg["ndepths"] = [8, 8, 8]
        (bench / "configs" / f"tiny_{name}.json").write_text(json.dumps(cfg))
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((bench / "workloads").glob("*.json")):
        w = json.loads(path.read_text())
        w.update(config=f"tiny_{w['config']}", **TINY)
        (bench / "workloads" / f"tiny_{path.name}").write_text(json.dumps(w))
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny_{c}" for c in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path, bench
