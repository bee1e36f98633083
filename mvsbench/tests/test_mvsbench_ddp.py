"""Mode ``train_ddp`` rehearsed on the CPU: four gloo ranks at 64x96 drive
``dtu_train``'s traffic with a global batch of 8 through the program's
data-parallel path (``init_multihost``, ``make_mesh``, synced batch norm,
DDP), rank 0 checks against the one-process reference on the whole global
batches, and leaving the ranks' exchange out fails that check."""

from __future__ import annotations

import json

import pytest

from mvsbench import faults, harness

CELL = "tiny_dtu_train_dp4"


@pytest.fixture
def dp4(tiny_bench):
    root, bench = tiny_bench
    w = json.loads((bench / "workloads" / "tiny_dtu_train.json").read_text())
    w.update(mode="train_ddp", chips=4, batch=8)
    w["traffic"]["scenes"] = 24
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": CELL, "config": w["config"], "traffic": CELL,
                             "chips": 4, "why": "rehearsal"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "tiny_dtu_train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, bench


def _run(dp4, traced=False):
    root, bench = dp4
    return harness.run(CELL, 2_147_483_659, 0.5, traced, device="cpu", bench_dir=bench,
                       root=root, log=lambda *a, **k: None)


def test_four_ranks_train_and_pass_the_check(dp4):
    result = _run(dp4)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert result["device"]["count"] == 4 and result["attempted"] % 8 == 0


def test_leaving_the_exchange_out_fails_the_check(dp4):
    with faults.planted("no_exchange"):
        result = _run(dp4)
    assert not result["correct"], result["checks"]
