"""The reduction of a traced run's Chrome trace by program span
(``mvsbench/program_spans.py``) and its five readers, on a hand-written
trace whose every number is worked out below (times in microseconds)."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from mvsbench import harness, program_spans
from mvsbench.trace import WINDOW

BENCH = Path(__file__).resolve().parents[1]
READERS = ("heads_ms.eval", "forward_idle_ms.eval", "forward_ms.train", "optimizer_ms.train",
           "step_idle_ms.train")
MAIN, AUTOGRAD = 1, 2

# (name, start, end, thread): the main thread's step, and a recomputed
# feature net on autograd's thread inside the backward's range
SPANS = [("train.step", 100, 900, MAIN), ("train.forward", 100, 400, MAIN),
         ("mvsnet.forward", 110, 390, MAIN), ("mvsnet.s1.sample", 112, 118, MAIN),
         ("mvsnet.s1.main.head", 150, 250, MAIN), ("train.backward", 400, 700, MAIN),
         ("mvsnet.feature", 440, 520, AUTOGRAD), ("train.optimizer", 700, 900, MAIN)]
# (correlation, launch time or None, thread, category, start, end) of each
# device operation: None is an operation no launch links to; the last two
# end or lie beyond the sub-window [0, 1000]
OPS = [(1, 115, MAIN, "kernel", 200, 205), (2, 120, MAIN, "kernel", 130, 200),
       (3, 160, MAIN, "kernel", 205, 215), (4, 395, MAIN, "kernel", 395, 420),
       (5, 450, AUTOGRAD, "kernel", 460, 600), (6, 710, MAIN, "gpu_memcpy", 720, 760),
       (99, None, MAIN, "kernel", 800, 810), (7, 950, MAIN, "kernel", 950, 980),
       (8, 960, MAIN, "gpu_memset", 990, 1010), (9, 1005, MAIN, "kernel", 1020, 1030)]

SELF = {"mvsnet.s1.sample": 5, "mvsnet.forward": 70, "mvsnet.s1.main.head": 10,
        "train.forward": 25, "mvsnet.feature": 140, "train.optimizer": 40, "train.step": 0,
        "train.backward": 0, "(unlinked)": 10, "(outside)": 40}
TOTAL = {"mvsnet.s1.sample": 5, "mvsnet.s1.main.head": 10, "mvsnet.forward": 85,
         "train.forward": 110, "train.backward": 140, "mvsnet.feature": 140,
         "train.optimizer": 40, "train.step": 290}
# each span's length less the union of [130, 215], [395, 420], [460, 600],
# [720, 760], [800, 810], [950, 980], [990, 1000] within it
IDLE = {"mvsnet.s1.sample": 6, "mvsnet.s1.main.head": 35, "mvsnet.forward": 195,
        "train.forward": 210, "train.backward": 140, "mvsnet.feature": 20,
        "train.optimizer": 150, "train.step": 500}


def _trace(spans=SPANS) -> dict:
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 1000,
               "tid": MAIN},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 300, "dur": 5, "tid": MAIN}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": t - s, "tid": tid}
               for n, s, t, tid in spans]
    for corr, at, tid, cat, s, t in OPS:
        if at is not None:
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": at, "dur": 3, "tid": tid, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": cat, "name": f"op{corr}", "ts": s, "dur": t - s,
                       "tid": 7, "args": {"correlation": corr}})
        events.append({"ph": "f", "cat": "ac2g", "name": "", "ts": s, "id": corr})
    return {"traceEvents": events}


def _ms(us: dict) -> dict:
    return {k: pytest.approx(v * 1e-3, rel=1e-12, abs=1e-15) for k, v in us.items()}


def test_self_total_and_idle_of_a_hand_written_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    red = program_spans.reduce(path)
    assert red["self_ms"] == _ms(SELF)
    assert red["total_ms"] == _ms(TOTAL)
    assert red["idle_ms"] == _ms(IDLE)
    assert red["busy_ms"] == pytest.approx(0.34) and red["window_ms"] == pytest.approx(1.0)
    # every operation in the sub-window is counted once, under one name
    assert sum(red["self_ms"].values()) == pytest.approx(red["busy_ms"])
    assert red["count"] == dict.fromkeys(TOTAL, 1)


@pytest.fixture
def cell(tmp_path, monkeypatch):
    """A benchmark folder holding one cell's workload file, whose trace the
    readers find by the workload's contents."""
    workload = dict(harness.cell_files("dtu_train")[0], batch=2)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "cell.json").write_text(json.dumps(workload))
    (tmp_path / ".cache" / "trace").mkdir(parents=True)
    monkeypatch.setattr(program_spans, "BENCH_DIR", tmp_path)
    return workload, tmp_path / ".cache" / "trace" / "cell.json"


def _reading(mode: str, workload: dict) -> harness.Reading:
    return harness.Reading(mode, workload, {}, 4, 30.0, {}, None, 1, None, None)


def test_the_readers_on_a_hand_written_trace(cell):
    workload, path = cell
    path.write_text(json.dumps(_trace()))
    got = {name: harness.metric_reader(name, BENCH)(_reading(mode, workload))
           for name, mode in zip(READERS, ("infer", "infer", "train", "train", "train"))}
    # one iteration of the sub-window; batch 2, so 2 maps
    assert got == {"heads_ms.eval": pytest.approx(0.015 / 2),
                   "forward_idle_ms.eval": pytest.approx(0.195 / 2),
                   "forward_ms.train": pytest.approx(0.110),
                   "optimizer_ms.train": pytest.approx(0.040),
                   "step_idle_ms.train": pytest.approx(0.500)}
    # a reader of the other mode reads nothing
    assert harness.metric_reader("heads_ms.eval", BENCH)(_reading("train", workload)) is None
    assert harness.metric_reader("step_idle_ms.train", BENCH)(_reading("train_ddp", workload)) \
        is None


@pytest.mark.parametrize("reader", READERS)
def test_every_reader_reads_nothing_without_program_spans(cell, reader):
    workload, path = cell
    mode = "infer" if reader.endswith(".eval") else "train"
    read = harness.metric_reader(reader, BENCH)
    assert read(_reading(mode, workload)) is None  # no trace at all
    path.write_text(json.dumps(_trace(spans=[])))
    assert program_spans.reduce(path) is None
    assert read(_reading(mode, workload)) is None
