"""The reduction of a traced run's Chrome trace by program span
(``mvsbench/program_spans.py``) and its five readers, on a hand-written
trace whose every number is worked out below (times in microseconds)."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from mvsbench import harness, program_spans
from mvsbench.counts import cost
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


def _reading(mode: str, workload: dict, kind: str | None = None) -> harness.Reading:
    return harness.Reading(mode, kind or mode, workload, {}, 4, 30.0, {}, [], 1, None, None, [])


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
    # a reader of the other kind reads nothing; a mode of the same kind is
    # read as that kind (train_ddp is a train mode)
    assert harness.metric_reader("heads_ms.eval", BENCH)(_reading("train", workload)) is None
    ddp = _reading("train_ddp", workload, kind="train")
    assert harness.metric_reader("step_idle_ms.train", BENCH)(ddp) == pytest.approx(0.500)


@pytest.mark.parametrize("reader", READERS)
def test_every_reader_reads_nothing_without_program_spans(cell, reader):
    workload, path = cell
    mode = "infer" if reader.endswith(".eval") else "train"
    read = harness.metric_reader(reader, BENCH)
    assert read(_reading(mode, workload)) is None  # no trace at all
    path.write_text(json.dumps(_trace(spans=[])))
    assert program_spans.reduce(path) is None
    assert read(_reading(mode, workload)) is None


# The per-layer readers' arithmetic before a mode's kind, every card's trace
# and the recorded cost passes came in, on one card: each reader of the
# standing cells has to give these numbers to the last bit.
def _least_before(config, workload, peaks):
    b, v = workload["batch"], workload["views"]
    h, w = workload["height"], workload["width"]
    n = len(config["ndepths"])
    total = 0.0
    for s, d in enumerate(config["ndepths"]):
        scale = 2 ** (n - s - 1)
        c = config["base_channels"] * 2 ** (n - 1 - s)
        for planes in (d, 4):
            nb, fl = cost.pass_cost(b, v, planes, h // scale, w // scale, c)
            total += max(nb / peaks["bytes_per_s"], fl / peaks["fp32_flops_per_s"])
    return total


def _k1(r):
    return [t for name, ts in r.trace["kernels"].items()
            if "warp_correlate_kernel" in name and "grad" not in name for t in ts]


BEFORE = {
    "mfu.eval": lambda r, red: 100.0 * r.ops_per_unit * r.units / r.window_s
    / r.peaks["fp32_flops_per_s"],
    "mfu.train": lambda r, red: 100.0 * r.ops_per_unit * r.units / r.window_s
    / (r.peaks["fp32_flops_per_s"] * r.workload["chips"]),
    "costreg_ms.eval": lambda r, red: r.span_ms["costreg"] / r.units,
    "feature_ms.eval": lambda r, red: r.span_ms["feature"] / r.units,
    "cost_pass_ms.eval": lambda r, red: r.span_ms["cost_pass"] / r.units,
    "backward_ms.train": lambda r, red: r.span_ms["backward"] / (r.units / r.workload["batch"]),
    "idle_pct.eval": lambda r, red: 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"]),
    "idle_pct.train": lambda r, red: 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"]),
    "warp_correlate_roofline": lambda r, red: 100.0 * _least_before(
        r.config, r.workload, r.peaks) * r.sub_iterations / sum(_k1(r)),
    "heads_ms.eval": lambda r, red: (red["self_ms"]["mvsnet.s1.sample"]
                                     + red["self_ms"]["mvsnet.s1.main.head"])
    / (r.sub_iterations * r.workload["batch"]),
    "forward_idle_ms.eval": lambda r, red: red["idle_ms"]["mvsnet.forward"]
    / (r.sub_iterations * r.workload["batch"]),
    "forward_ms.train": lambda r, red: (red["total_ms"]["train.forward"]
                                        + red["total_ms"].get("train.loss", 0.0))
    / r.sub_iterations,
    "optimizer_ms.train": lambda r, red: red["total_ms"]["train.optimizer"] / r.sub_iterations,
    "step_idle_ms.train": lambda r, red: red["idle_ms"]["train.step"] / r.sub_iterations,
}
STANDING = ("dtu_eval", "dtu_train", "tank_eval")


@pytest.mark.parametrize("name", STANDING)
def test_every_reader_of_a_standing_cell_reads_as_before(tmp_path, monkeypatch, name):
    """A one-card cell's traced run, written by hand: every per-layer
    metric that the cell lists reads a number, equal to the last bit to the
    arithmetic above; the count's operations and passes come from the
    cell's own mode on the meta device, as in a traced run."""
    workload, config = harness.cell_files(name)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / f"{name}.json").write_text(json.dumps(workload))
    (tmp_path / ".cache" / "trace").mkdir(parents=True)
    (tmp_path / ".cache" / "trace" / f"{name}.json").write_text(json.dumps(_trace()))
    monkeypatch.setattr(program_spans, "BENCH_DIR", tmp_path)
    mode = harness.mode_module(workload["mode"], BENCH)
    ctx = harness.Context(name, workload, config, 1, "cpu")
    b, v, h, w = workload["batch"], workload["views"], workload["height"], workload["width"]
    host = {"imgs": np.zeros((b, v, h, w, 3), np.float32),
            "proj_matrices": {f"stage{s}": np.zeros((b, v, 2, 4, 4), np.float32)
                              for s in (1, 2, 3)},
            "depth_values": np.zeros((b, config["numdepth"]), np.float32)}
    for key in ("depth", "mask"):
        host[key] = {f"stage{s}": np.zeros((b, h >> (3 - s), w >> (3 - s)), np.float32)
                     for s in (1, 2, 3)}
    state = SimpleNamespace(ctx=ctx, batches=[host], ref_batches=[host])
    ops, passes = mode.count(state)
    summary = {"window_s": 0.925, "busy_s": 0.8710937, "collective_s": 0.0,
               "collective_exposed_s": 0.0,
               "kernels": {"warp_correlate_kernel(float const*)": [1.37e-3, 1.4e-4, 3.1e-3],
                           "warp_correlate_grad_src_kernel": [9e-3], "other": [0.5]}}
    r = harness.Reading(workload["mode"], mode.KIND, workload, config, 54, 30.0117, {
        "costreg": 6401.5, "feature": 690.25, "cost_pass": 259.3, "backward": 8066.1},
        [summary], workload["trace_iterations"], ops,
        harness.peaks_for("NVIDIA H100 80GB HBM3"), passes)
    red = program_spans.reduce(tmp_path / ".cache" / "trace" / f"{name}.json")
    _, layer = harness.cell_metrics(json.loads((BENCH.parent / "BENCHMARK.json").read_text()),
                                    name)
    assert layer
    for m in layer:
        got = harness.metric_reader(m["name"], BENCH)(r)
        assert got is not None and got == BEFORE[m["name"]](r, red), m["name"]


def test_the_idle_share_of_several_cards_is_their_mean():
    workload = dict(harness.cell_files("dtu_train_dp4")[0])
    traces = [{"window_s": 2.0, "busy_s": b} for b in (1.5, 1.8, 1.9, 1.6)]
    read = harness.metric_reader("idle_pct.train", BENCH)
    r = harness.Reading("train_ddp", "train", workload, {}, 8, 30.0, {}, traces, 2, None, None,
                        [])
    assert read(r) == pytest.approx((25.0 + 10.0 + 5.0 + 20.0) / 4, rel=1e-12)
    # a card on which no operation ran leaves nothing to read
    traces[2] = {"window_s": 2.0, "busy_s": 0.0}
    assert read(r) is None


def test_the_exposed_all_reduce_is_the_least_over_the_cards():
    """The card that waited least for the others gives the reading; a card
    on which no NCCL kernel ran leaves nothing to read."""
    workload = dict(harness.cell_files("dtu_train_dp4")[0])
    traces = [{"window_s": 2.0, "busy_s": 1.5, "collective_s": c, "collective_exposed_s": e}
              for c, e in ((0.9, 0.6), (0.5, 0.2), (0.7, 0.4), (0.6, 0.3))]
    read = harness.metric_reader("allreduce_exposed_ms.train", BENCH)
    r = harness.Reading("train_ddp", "train", workload, {}, 8, 30.0, {}, traces, 2, None, None,
                        [])
    assert read(r) == pytest.approx(1e3 * 0.2 / 2, rel=1e-12)
    traces[3] = dict(traces[3], collective_s=0.0, collective_exposed_s=0.0)
    assert read(r) is None
    assert read(harness.Reading("train", "train", workload, {}, 8, 30.0, {}, traces[3:], 2,
                                None, None, [])) is None
