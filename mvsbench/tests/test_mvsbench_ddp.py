"""Mode ``train_ddp`` rehearsed on the CPU: four gloo ranks at 64x96 drive
``dtu_train_dp4``'s traffic (a global batch of 8) through the program's
data-parallel path (``init_multihost``, ``make_mesh``, synced batch norm,
DDP), rank 0 checks against the one-process reference on the whole global
batches, leaving the ranks' exchange out fails that check, and a traced run
is read from every rank."""

from __future__ import annotations

import json

import pytest

from mvsbench import faults, harness
from mvsbench import trace as trace_lib
from mvsbench.modes import train_ddp

CELL = "tiny_dtu_train_dp4"
SEED = 2_147_483_659
PEAK = {"fp32_flops_per_s": 1e12, "bytes_per_s": 1e11}


@pytest.fixture
def bench(tiny_bench):
    """``tiny_bench`` with the tiny cell listed as ``dtu_train_dp4`` would
    be: under every metric of ``dtu_train``, and under
    ``allreduce_exposed_ms.train``."""
    root, _ = tiny_bench
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "tiny_dtu_train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    doc["per_layer"].append({"name": "allreduce_exposed_ms.train", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "parallel/", "moves": "train_samples_per_s",
                             "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return tiny_bench


def _run(bench, traced=False, log=lambda *a, **k: None):
    root, folder = bench
    return harness.run(CELL, SEED, 0.5, traced, device="cpu", bench_dir=folder, root=root,
                       log=log)


def test_four_ranks_train_and_pass_the_check(bench):
    lines = []
    result = _run(bench, log=lambda line, **k: lines.append(line))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    # the check's seconds and the parameter or buffer behind each worst gap
    checked = json.loads(next(x for x in lines if x.startswith("checked ")).split(" ", 1)[1])
    assert checked["check_s"] > 0 and set(checked["worst"]) == {"grad", "update", "stats"}
    assert result["device"]["count"] == 4 and result["attempted"] % 8 == 0


def test_every_rank_runs_with_one_thread_as_under_torchrun():
    assert train_ddp._env(1, 4, 29500)["OMP_NUM_THREADS"] == "1"


def test_leaving_the_exchange_out_fails_the_check(bench):
    with faults.planted("no_exchange"):
        result = _run(bench)
    assert not result["correct"], result["checks"]


def test_a_traced_run_is_read_from_every_rank(bench, monkeypatch):
    """Every rank profiles the sub-window and hands rank 0 its summary and
    its peak: the card's window and busy time are the four ranks' mean, the
    peak the fullest rank's, ``mfu.train`` is over four cards' peak (a row
    of peaks stands in for the card's), and the span metrics are rank 0's.
    On the CPU no device operation is traced, so the idle readers read
    nothing; ``test_mvsbench_program_spans`` holds their mean."""
    monkeypatch.setattr(harness, "peaks_for", lambda *a, **k: PEAK)
    lines = []
    result = _run(bench, True, log=lambda line, **k: lines.append(line))
    assert result["correct"], result["checks"]
    info = json.loads(next(x for x in lines if x.startswith("info ")).split(" ", 1)[1])
    by_rank = info["by_rank"]
    assert len(by_rank["memory_peak_bytes"]) == len(by_rank["idle_pct"]) == 4
    assert result["device"]["memory_peak_bytes"] == max(by_rank["memory_peak_bytes"])

    traces = bench[1] / ".cache" / "trace"
    paths = [traces / f"{CELL}.json"] + [traces / f"{CELL}.rank{r}.json" for r in (1, 2, 3)]
    windows = [trace_lib.summarise(p)["window_s"] for p in paths]
    assert result["device"]["window_s"] == pytest.approx(sum(windows) / 4, rel=1e-12)
    assert result["device"]["busy_s"] == 0.0

    metrics = result["metrics"]
    assert {"mfu.train", "backward_ms.train"} <= set(metrics), metrics
    assert "idle_pct.train" not in metrics and "allreduce_exposed_ms.train" not in metrics
    units = result["attempted"]
    want = 100.0 * info["count"]["ops_per_unit"] * units / info["window_s"] / (4 * 1e12)
    assert metrics["mfu.train"]["value"] == pytest.approx(want, rel=1e-12)
