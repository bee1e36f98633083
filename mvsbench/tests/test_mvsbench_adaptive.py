"""The configuration ``dmvsnet_tank_adaptive`` and its reference
(``reference/adaptive.py``) on the CPU, at 64x96, 3 views, 8/8/8 planes, on
the benchmark's own seeded weights and scenes; and the reader
``agg_gate_ms.eval`` on hand-written traces.

* the program with ``agg_mode="adaptive"`` (its plain path) against the
  reference: every stage's depth and probability volume;
* the frozen count of the reference equals the program's own count, and
  records V - 1 passes at V = 2 for each of the six cost passes;
* the cell ``tank_adaptive`` at that size through the harness: the program
  passes, its bf16 control and a planted fault fail, and so does the
  program against a copy of the reference whose gate is forced to 1;
* ``agg_gate_ms.eval`` sums the gates' device time per map, and reads
  nothing on a variance trace or a train run.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from dmvsnet_tpu_torch.engine import profiler
from dmvsnet_tpu_torch.engine.train import build_model
from mvsbench import faults, harness, program, program_spans, weights
from mvsbench.counts import cost as counts
from mvsbench.reference import adaptive
from mvsbench.trace import WINDOW
from mvsbench.traffic import scenes

BENCH = Path(__file__).resolve().parents[1]
SEED = 2_147_483_659  # above 2**31
CELL = "tank_adaptive"
H, W, V = 64, 96, 3


def _tiny(workload: dict, config: dict) -> tuple[dict, dict]:
    return ({**workload, "height": H, "width": W, "views": V},
            {**config, "ndepths": [8, 8, 8]})


@pytest.fixture(scope="module")
def models():
    """The program and the reference on one seed's weights, and one batch of
    the cell's traffic."""
    workload, config = _tiny(*harness.cell_files(CELL))
    ctx = SimpleNamespace(config=config, workload=workload, seed=SEED, options={}, device="cpu")
    cfg = program.config(ctx)
    assert cfg.agg_mode == "adaptive"
    model = build_model(cfg, torch.device("cpu"))
    sd = weights.generate(model.state_dict(), SEED, "cpu")
    model.load_state_dict(sd)
    ref = harness.reference_module(config).build(config, "cpu")
    assert isinstance(ref, adaptive.AdaptiveMVSNet)
    ref.load_state_dict(sd)  # strict: the weight nets have the program's names
    pool = scenes.pool(SEED, workload["traffic"], V, H, W, 3, cfg.numdepth, "cpu")
    batch = scenes.batches(pool, workload["batch"], 1)[0]
    tree = lambda v: {k: tree(x) for k, x in v.items()} if isinstance(v, dict) \
        else torch.from_numpy(v)  # noqa: E731
    batch = {k: tree(v) for k, v in batch.items()}
    return model.eval(), ref.eval(), (batch["imgs"], batch["proj_matrices"],
                                      batch["depth_values"]), config


def test_the_reference_matches_the_adaptive_program(models):
    model, ref, args, _ = models
    with torch.no_grad():
        got, want = model(*args), ref(*args)
    for s in ("stage1", "stage2", "stage3"):
        # the same fp32 operations in the same order on both sides (the
        # program's plain pass per pair, the same 1x1x1 convolutions, batch
        # norms, sigmoid and sum): what is left is the CPU convolutions'
        # own rounding, a few ulp of a depth of 1000-8000 mm
        torch.testing.assert_close(got[s]["depth"], want[s]["depth"], rtol=1e-6, atol=1e-5,
                                   msg=s)
        # probabilities lie in [0, 1]: a few float32 ulp of 1
        torch.testing.assert_close(got[s]["prob_volume"], want[s]["prob_volume"], rtol=0,
                                   atol=1e-6, msg=s)


def test_the_frozen_count_equals_the_programs_and_counts_each_pair(models):
    model, ref, args, config = models
    with torch.no_grad():
        want = profiler.cost_analysis(model, *args)
    got = counts.eval_counter(ref, *args)
    assert got.totals() == want
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    on_meta = counts.eval_counter(adaptive.build(config, "meta"), meta(args[0]),
                                  {k: meta(v) for k, v in args[1].items()}, meta(args[2]))
    assert on_meta.totals()["flops"] == want["flops"] > 0
    shapes = [p["shape"] for p in got.passes]
    assert shapes == [p["shape"] for p in on_meta.passes]
    # V - 1 passes at V = 2 for each (stage, pass), in the forward's order
    assert [s[1] for s in shapes] == [2] * (6 * (V - 1))
    assert [s[2] for s in shapes] == [d for d in (8, 4, 8, 4, 8, 4) for _ in range(V - 1)]
    assert not any(p["adjoint"] for p in got.passes)


@pytest.fixture
def tiny_adaptive(tiny_bench):
    """The benchmark at 64x96 with ``tiny_tank_adaptive`` on a configuration
    ``tiny_dmvsnet_tank_adaptive`` (8/8/8 planes)."""
    root, bench = tiny_bench
    cfg = json.loads((bench / "configs" / "dmvsnet_tank_adaptive.json").read_text())
    (bench / "configs" / "tiny_dmvsnet_tank_adaptive.json").write_text(
        json.dumps({**cfg, "ndepths": [8, 8, 8]}))
    return root, bench


def _run(bench, cell="tiny_tank_adaptive", options=None, traced=False):
    root, folder = bench
    lines = []
    result = harness.run(cell, SEED, 0.3, traced, device="cpu", bench_dir=folder, root=root,
                         options=options, log=lambda line, **k: lines.append(line))
    info = json.loads(next(x for x in lines if x.startswith("info ")).split(" ", 1)[1])
    return result, info


def test_the_cell_passes_and_its_bf16_control_fails(tiny_adaptive):
    sound, info = _run(tiny_adaptive, traced=True)
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == {"depth_mean_mm", "prob"}
    assert [p[1] for p in info["count"]["passes"]] == [2] * (6 * (V - 1))
    # on the CPU no device op is traced: the gate's reader reads nothing
    assert "agg_gate_ms.eval" not in sound["metrics"]
    control, _ = _run(tiny_adaptive, options={"compute_dtype": "bfloat16"})
    assert not control["correct"], control["checks"]


def test_a_fault_under_the_timed_path_fails(tiny_adaptive):
    with faults.planted("altered"):
        result, _ = _run(tiny_adaptive)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_a_reference_without_the_gate_fails_the_check(tiny_adaptive):
    """A copy of ``reference/adaptive.py`` whose gate is 1 everywhere, named
    by the configuration, turns the program's run incorrect."""
    root, bench = tiny_adaptive
    source = (BENCH / "reference" / "adaptive.py").read_text()
    assert source.count("torch.sigmoid(logits)") == 1
    (bench / "reference" / "ungated.py").write_text(
        source.replace("torch.sigmoid(logits)", "torch.ones_like(logits)"))
    cfg = json.loads((bench / "configs" / "tiny_dmvsnet_tank_adaptive.json").read_text())
    (bench / "configs" / "tiny_ungated.json").write_text(json.dumps({**cfg,
                                                                   "reference": "ungated"}))
    w = json.loads((bench / "workloads" / "tiny_tank_adaptive.json").read_text())
    (bench / "workloads" / "tiny_ungated.json").write_text(json.dumps({**w,
                                                                     "config": "tiny_ungated"}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for m in doc["end_to_end"]:
        if "tiny_tank_adaptive" in m.get("workloads", []):
            m["workloads"].append("tiny_ungated")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    result, _ = _run(tiny_adaptive, "tiny_ungated")
    assert not result["correct"], result["checks"]


# ----------------------------------------------- agg_gate_ms.eval by hand

MAIN = 1
# (name, start, end): one dispatch of two source views; the gates lie
# inside their pass's cost span, as the program opens them
SPANS = [("mvsnet.forward", 100, 900), ("mvsnet.s1.main.cost", 110, 300),
         ("mvsnet.s1.main.gate", 150, 200), ("mvsnet.s1.main.gate", 240, 290),
         ("mvsnet.s1.main.costreg", 300, 500), ("mvsnet.s1.refine.cost", 500, 700),
         ("mvsnet.s1.refine.gate", 560, 600), ("mvsnet.s1.refine.gate", 640, 690)]
# (correlation, launch time, start, end) of each kernel: a pair's kernel 1
# launched in the cost span, the weight net's kernels in the gates (one
# ending past the gate's range still counts whole), the U-Net's
OPS = [(1, 120, 130, 150), (2, 155, 160, 170), (3, 190, 195, 230), (4, 220, 230, 240),
       (5, 250, 250, 262), (6, 310, 320, 480), (7, 565, 570, 575), (8, 650, 655, 671)]
GATE_US = 10 + 35 + 12 + 5 + 16


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
def gate_cell(tmp_path, monkeypatch):
    """A benchmark folder with ``tank_adaptive``'s workload file (batch 2 for
    the arithmetic), whose trace the reader finds by its contents."""
    workload = dict(harness.cell_files(CELL)[0], batch=2)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / f"{CELL}.json").write_text(json.dumps(workload))
    (tmp_path / ".cache" / "trace").mkdir(parents=True)
    monkeypatch.setattr(program_spans, "BENCH_DIR", tmp_path)
    return workload, tmp_path / ".cache" / "trace" / f"{CELL}.json"


def _reading(workload: dict, kind: str = "infer", sub: int = 1) -> harness.Reading:
    return harness.Reading(kind, kind, workload, {}, 4, 30.0, {}, [], sub, None, None, [])


def test_the_gate_reader_on_a_hand_written_trace(gate_cell):
    workload, path = gate_cell
    read = harness.metric_reader("agg_gate_ms.eval", BENCH)
    assert read(_reading(workload)) is None  # no trace yet
    path.write_text(json.dumps(_trace(SPANS)))
    # one dispatch of batch 2: two maps
    assert read(_reading(workload)) == pytest.approx(GATE_US * 1e-3 / 2, rel=1e-12)
    assert read(_reading(workload, sub=2)) == pytest.approx(GATE_US * 1e-3 / 4, rel=1e-12)
    assert read(_reading(workload, kind="train")) is None


def test_the_gate_reader_reads_nothing_on_a_variance_trace(gate_cell):
    workload, path = gate_cell
    path.write_text(json.dumps(_trace([sp for sp in SPANS if not sp[0].endswith(".gate")])))
    assert program_spans.reduction(_reading(workload)) is not None
    assert harness.metric_reader("agg_gate_ms.eval", BENCH)(_reading(workload)) is None
