"""The configuration ``transmvsnet_tank`` and its reference
(``reference/transmvsnet.py``) on the CPU, at 64x96, 3 views, 8/8/8 planes,
on the benchmark's own seeded weights and scenes; and the readers
``fmt_ms.eval``, ``arf_ms.eval``, ``view_weight_ms.eval`` and
``pair_cost_ms.eval`` on a hand-written trace.

* the cell ``tank_transmvsnet`` at that size through the harness (mode
  ``infer_cascade``): set-up, the window, the traced sub-window's spans, the
  frozen count (V - 1 pair passes at V = 2 a stage) and the check pass;
* the check fails with the reference's transformer layers scaled by 1.01,
  under the bf16 control (on ``prob``) and under the planted ``altered``
  answer (on ``depth_mean_mm``);
* the check runs the reference once for each distinct set of seeding
  depths among a batch's dispatches;
* the readers sum their spans' device time per map, and read nothing on a
  trace without those spans or on a train run.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from mvsbench import faults, harness, program_spans
from mvsbench.reference import transmvsnet
from mvsbench.trace import WINDOW

BENCH = Path(__file__).resolve().parents[1]
SEED = 2_147_484_101  # above 2**31
CELL = "tank_transmvsnet"
V = 3


@pytest.fixture
def tiny_cell(tiny_bench):
    """The benchmark at 64x96 with ``tiny_tank_transmvsnet`` on a
    configuration ``tiny_transmvsnet_tank`` (8/8/8 planes)."""
    root, bench = tiny_bench
    cfg = json.loads((bench / "configs" / "transmvsnet_tank.json").read_text())
    (bench / "configs" / "tiny_transmvsnet_tank.json").write_text(
        json.dumps({**cfg, "ndepths": [8, 8, 8]}))
    return root, bench


def _run(bench, traced=False):
    root, folder = bench
    lines = []
    result = harness.run(f"tiny_{CELL}", SEED, 0.3, traced, device="cpu", bench_dir=folder,
                         root=root, log=lambda line, **k: lines.append(line))
    info = json.loads(next(x for x in lines if x.startswith("info ")).split(" ", 1)[1])
    return result, info


def test_the_cell_runs_counts_and_checks(tiny_cell):
    result, info = _run(tiny_cell, traced=True)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"depth_mean_mm", "prob"}
    assert result["failed"] == 0 and result["attempted"] > 0
    # one pair pass at V = 2 per source view and stage, in the forward's order
    passes = info["count"]["passes"]
    assert [p[1] for p in passes] == [2] * (3 * (V - 1))
    assert [p[2] for p in passes] == [8] * (3 * (V - 1))
    assert info["count"]["ops_per_unit"] > 0
    # the feature net and the three U-Nets are spanned; no device op is
    # traced on the CPU, so the program-span readers read nothing
    assert {"feature_ms.eval", "costreg_ms.eval"} <= set(result["metrics"])
    assert not {"fmt_ms.eval", "arf_ms.eval", "view_weight_ms.eval",
                "pair_cost_ms.eval"} & set(result["metrics"])


def test_the_check_fails_when_the_reference_transformer_is_off(tiny_cell, monkeypatch):
    real = transmvsnet.LoFTREncoderLayer.forward
    monkeypatch.setattr(transmvsnet.LoFTREncoderLayer, "forward",
                        lambda self, x, source: real(self, x, source) * 1.01)
    result, _ = _run(tiny_cell)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_the_bf16_control_fails_prob(tiny_cell):
    root, folder = tiny_cell
    result = harness.run(f"tiny_{CELL}", SEED, 0.3, False, device="cpu", bench_dir=folder,
                         root=root, options={"compute_dtype": "bfloat16"},
                         log=lambda *a, **k: None)
    assert not result["correct"]
    prob = result["checks"]["prob"]
    assert prob["value"] > prob["limit"], result["checks"]


def test_an_altered_answer_fails_depth(tiny_cell):
    root, folder = tiny_cell
    with faults.planted("altered"):
        result = harness.run(f"tiny_{CELL}", SEED, 0.3, False, device="cpu", bench_dir=folder,
                             root=root, log=lambda *a, **k: None)
    assert not result["correct"] and result["failed"] > 0
    depth = result["checks"]["depth_mean_mm"]
    assert depth["value"] > depth["limit"], result["checks"]


# ------------------------------------------------- the readers by hand

MAIN = 1
# (name, start, end): one dispatch; the ARF heads inside the feature net,
# the view weights inside the stage-1 cost span
SPANS = [("mvsnet.forward", 100, 990), ("mvsnet.feature", 100, 300),
         ("mvsnet.arf.s1", 150, 200), ("mvsnet.arf.s3", 240, 290),
         ("mvsnet.fmt", 300, 400), ("mvsnet.s1.main.cost", 400, 600),
         ("mvsnet.s1.main.view_weight", 450, 480), ("mvsnet.s1.main.view_weight", 520, 560),
         ("mvsnet.s1.main.costreg", 600, 700), ("mvsnet.s2.main.cost", 700, 800)]
# (correlation, launch time, start, end): an ARF kernel running past its
# span's end still counts whole
OPS = [(1, 160, 165, 180), (2, 250, 255, 295), (3, 310, 320, 390), (4, 410, 420, 440),
       (5, 455, 460, 470), (6, 530, 535, 550), (7, 610, 620, 690), (8, 710, 720, 760)]
ARF_US, FMT_US, VIEW_US, PAIR_US = 15 + 40, 70, 10 + 15, 20 + 40


def _trace(spans) -> dict:
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 1000,
               "tid": MAIN}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": t - s,
                "tid": MAIN} for n, s, t in spans]
    for corr, at, s, t in OPS:
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at,
                       "dur": 3, "tid": MAIN, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"op{corr}", "ts": s, "dur": t - s,
                       "tid": 7, "args": {"correlation": corr}})
    return {"traceEvents": events}


@pytest.fixture
def traced_cell(tmp_path, monkeypatch):
    """A benchmark folder with the cell's workload file (batch 2 for the
    arithmetic), whose trace the readers find by its contents."""
    workload = dict(harness.cell_files(CELL)[0], batch=2)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / f"{CELL}.json").write_text(json.dumps(workload))
    (tmp_path / ".cache" / "trace").mkdir(parents=True)
    monkeypatch.setattr(program_spans, "BENCH_DIR", tmp_path)
    return workload, tmp_path / ".cache" / "trace" / f"{CELL}.json"


def _reading(workload: dict, kind: str = "infer", sub: int = 1) -> harness.Reading:
    return harness.Reading(kind, kind, workload, {}, 4, 30.0, {}, [], sub, None, None, [])


@pytest.mark.parametrize("metric,us", [("fmt_ms.eval", FMT_US), ("arf_ms.eval", ARF_US),
                                       ("view_weight_ms.eval", VIEW_US),
                                       ("pair_cost_ms.eval", PAIR_US)])
def test_a_reader_on_a_hand_written_trace(traced_cell, metric, us):
    workload, path = traced_cell
    read = harness.metric_reader(metric, BENCH)
    assert read(_reading(workload)) is None  # no trace yet
    path.write_text(json.dumps(_trace(SPANS)))
    # one dispatch of batch 2: two maps
    assert read(_reading(workload)) == pytest.approx(us * 1e-3 / 2, rel=1e-12)
    assert read(_reading(workload, sub=2)) == pytest.approx(us * 1e-3 / 4, rel=1e-12)
    assert read(_reading(workload, kind="train")) is None


@pytest.mark.parametrize("metric", ["fmt_ms.eval", "arf_ms.eval", "view_weight_ms.eval",
                                    "pair_cost_ms.eval"])
def test_a_reader_reads_nothing_on_a_dmvsnet_trace(traced_cell, metric):
    workload, path = traced_cell
    dmvsnet = [(n.replace("view_weight", "cost").replace("fmt", "feature"), s, t)
               for n, s, t in SPANS if not n.startswith("mvsnet.arf")]
    path.write_text(json.dumps(_trace(dmvsnet)))
    assert harness.metric_reader(metric, BENCH)(_reading(workload)) is None


def test_dispatches_with_other_seeding_depths_get_a_reference_run_each():
    mode = harness.mode_module("infer_cascade", BENCH)
    a, b = torch.zeros(1, 2, 2), torch.ones(1, 2, 2)
    state = SimpleNamespace(answers=[(0, None), (1, None), (0, None), (0, None)],
                            seeded=[{"stage1": a}, {"stage1": b}, {"stage1": b},
                                    {"stage1": a.clone()}])
    last = {0: {"stage1": (a.numpy(), None)}}
    groups = mode._groups(state, 0, last, ["stage1"])
    assert [(g["answers"], g["last"]) for g in groups] == [([0, 3], True), ([2], False)]
    assert [g["answers"] for g in mode._groups(state, 1, last, ["stage1"])] == [[1]]
