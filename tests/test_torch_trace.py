"""The program's spans (``dmvsnet_tpu_torch/utils/trace.py``) on the CPU, at
the size of tests/test_torch_remat.py (32x64, 3 views, batch 1, ndepths
8/8/8):

* with no profiler running a span never reaches ``record_function``: an
  eval forward and a train step run with it made to raise;
* under ``torch.profiler`` an eval forward records exactly the model's 23
  spans, once each, every ``mvsnet.s{k}.*`` and ``mvsnet.feature`` inside
  ``mvsnet.forward``; a train step fed by ``shard_batch`` adds
  ``train.h2d`` before ``train.step`` and the step's five phases inside it,
  with the forward inside ``train.forward``; under remat the recomputed
  feature net, cost passes and cost U-Nets open their spans again inside
  ``train.backward``; ``train.load`` marks every fetch of a loader; an
  adaptive forward adds ``mvsnet.s{k}.{p}.gate`` spans inside each pass's
  ``cost`` span: one around the gated pass where the weight nets fold (an
  fp32 eval forward without autograd), V - 1, one per source view, on the
  per-pair route (with autograd on); a variance forward none;
* outputs, gradients and running statistics are equal bit for bit with the
  profiler on and off (under deterministic algorithms, as the remat test);
* ``engine/profiler.breakdown`` reports every span of a forward and of a
  step.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from dmvsnet_tpu_torch.engine import profiler
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.engine.train import _spanned_fetches
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.parallel import make_mesh, shard_batch
from dmvsnet_tpu_torch.utils import synthetic, trace

NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
H, W, V = 32, 64, 3
STAGE_SPANS = [f"mvsnet.s{k}.{part}" for k in (1, 2, 3)
               for part in ("sample", *(f"{p}.{x}" for p in ("main", "refine")
                                        for x in ("cost", "costreg", "head")))]
FORWARD_SPANS = ["mvsnet.forward", "mvsnet.feature", *STAGE_SPANS]
PHASES = ["train.forward", "train.loss", "train.backward", "train.metrics", "train.optimizer"]
RECOMPUTED = ["mvsnet.feature", *(s for s in STAGE_SPANS if s.endswith(("cost", "costreg")))]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@contextlib.contextmanager
def deterministic():
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


@pytest.fixture(scope="module")
def weights() -> dict:
    """Seeded weights with damped probability heads (as
    tests/test_torch_remat.py), so that a step stays finite."""
    model = _model()
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def host_batch() -> dict:
    batch = synthetic.make_batch(batch=1, n_views=V, height=H, width=W, n_depths=32)
    rng = np.random.default_rng(0)
    batch["imgs"] = (batch["imgs"] + rng.normal(0, 0.02, batch["imgs"].shape)).astype(np.float32)
    return batch


def _model(**kw) -> MVSNet:
    # CPU tensors: the kernel path runs its plain version
    return MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                  warp_impl="cuda", **kw)


def _forward(weights, host_batch) -> dict:
    model = _model()
    model.load_state_dict(weights)
    batch = shard_batch(host_batch, make_mesh(1))
    with torch.inference_mode():
        out = model.eval()(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def _step(weights, host_batch, **kw) -> dict:
    model = _model(**kw)
    model.load_state_dict(weights)
    opt, sched = make_optimizer(model.parameters(), lambda n: 1e-3)
    batch = shard_batch(host_batch, make_mesh(1))
    scalars, (depth, conf) = make_train_step()(model, opt, sched, batch)
    return dict(scalars={k: float(v) for k, v in scalars.items()}, depth=depth, conf=conf,
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def _spans(run, tmp_path) -> list[tuple[str, float, float, int]]:
    """(name, start, end, thread) of every program span that ``run()``
    records under a CPU profiler, in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(trace.PREFIXES)]
    return sorted(spans, key=lambda sp: sp[1])


def _within(spans, inner: str, outer: str) -> bool:
    """Every range of ``inner`` lies within a range of ``outer``."""
    outs = [(s, t) for n, s, t, _ in spans if n == outer]
    return all(any(a <= s and t <= b for a, b in outs) for n, s, t, _ in spans if n == inner)


def test_no_span_reaches_record_function_without_a_profiler(weights, host_batch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    # torch's own ranges (Optimizer.step's) call it whatever runs: refuse
    # the spans' alone
    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("train.step") is trace.span("mvsnet.forward")
    assert torch.isfinite(_forward(weights, host_batch)["depth"]).all()
    assert np.isfinite(_step(weights, host_batch)["scalars"]["loss"])


def test_an_eval_forward_records_the_models_spans(weights, host_batch, tmp_path):
    spans = _spans(lambda: _forward(weights, host_batch), tmp_path)
    assert sorted(n for n, *_ in spans) == sorted(["train.h2d", *FORWARD_SPANS])
    for name in FORWARD_SPANS[1:]:
        assert _within(spans, name, "mvsnet.forward"), name
    for k in (1, 2, 3):
        for part in ("cost", "costreg", "head"):
            # a stage's main pass comes before its refine pass
            main = [s for n, s, *_ in spans if n == f"mvsnet.s{k}.main.{part}"]
            refine = [s for n, s, *_ in spans if n == f"mvsnet.s{k}.refine.{part}"]
            assert main < refine


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_a_train_step_records_its_phases_and_the_forward(weights, host_batch, tmp_path, remat):
    spans = _spans(lambda: _step(weights, host_batch, remat=remat), tmp_path)
    again = RECOMPUTED if remat else []
    assert sorted(n for n, *_ in spans) == sorted(
        ["train.h2d", "train.step", *PHASES, *FORWARD_SPANS, *again])
    h2d = [t for n, _, t, _ in spans if n == "train.h2d"]
    step = [s for n, s, _, _ in spans if n == "train.step"]
    assert h2d[0] <= step[0]
    for phase in PHASES:
        assert _within(spans, phase, "train.step"), phase
    starts = [s for n, s, *_ in spans if n in PHASES]
    assert [n for n, s, *_ in spans if n in PHASES] == PHASES and starts == sorted(starts)
    forward = [sp for sp in spans if sp[2] <= min(t for n, _, t, _ in spans
                                                  if n == "train.forward")]
    for name in FORWARD_SPANS:
        assert _within(forward, name, "train.forward"), name
    if remat:
        recomputed = [sp for sp in spans if sp[1] >= min(s for n, s, _, _ in spans
                                                         if n == "train.backward")]
        assert sorted(n for n, *_ in recomputed if n.startswith("mvsnet.")) == sorted(RECOMPUTED)
        for name in RECOMPUTED:
            assert _within(recomputed, name, "train.backward"), name


def _adaptive_forward(host_batch, grad: bool = False) -> None:
    model = _model(agg_mode="adaptive")
    init_weights(model, torch.Generator().manual_seed(1))
    batch = shard_batch(host_batch, make_mesh(1))
    with torch.enable_grad() if grad else torch.inference_mode():
        model.eval()(batch["imgs"], batch["proj_matrices"], batch["depth_values"])


@pytest.mark.parametrize("agg_mode", ["adaptive", "adaptive_per_pair", "variance"])
def test_the_adaptive_gate_is_a_span_per_source_view(weights, host_batch, tmp_path, agg_mode):
    """Each (stage, pass) of an adaptive forward opens ``gate`` spans inside
    its ``cost`` span: one around the gated pass in an fp32 eval forward
    without autograd, V - 1, one per source view, on the per-pair route
    (the same forward with autograd on); a variance forward opens none."""
    run = {"adaptive": lambda: _adaptive_forward(host_batch),
           "adaptive_per_pair": lambda: _adaptive_forward(host_batch, grad=True),
           "variance": lambda: _forward(weights, host_batch)}[agg_mode]
    spans = _spans(run, tmp_path)
    per_pass = {"adaptive": 1, "adaptive_per_pair": V - 1, "variance": 0}[agg_mode]
    passes = [f"mvsnet.s{k}.{p}" for k in (1, 2, 3) for p in ("main", "refine")]
    assert sorted(n for n, *_ in spans if n.endswith(".gate")) == sorted(
        f"{p}.gate" for p in passes for _ in range(per_pass))
    assert sorted(n for n, *_ in spans if not n.endswith(".gate")) == sorted(
        ["train.h2d", *FORWARD_SPANS])
    for p in passes:
        assert _within(spans, f"{p}.gate", f"{p}.cost"), p


def test_every_fetch_of_a_loader_is_a_span(tmp_path):
    batches = []
    spans = _spans(lambda: batches.extend(_spanned_fetches([{"i": 0}, {"i": 1}])), tmp_path)
    assert batches == [{"i": 0}, {"i": 1}]
    # two batches and the fetch that finds the loader exhausted
    assert [n for n, *_ in spans] == ["train.load"] * 3


def test_the_profiler_changes_no_result(weights, host_batch):
    def run():
        return _forward(weights, host_batch), _step(weights, host_batch)

    with deterministic():
        off = run()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            on = run()
    for k, v in off[0].items():
        assert torch.equal(v, on[0][k]), k
    a, b = off[1], on[1]
    assert a["scalars"] == b["scalars"]
    assert torch.equal(a["depth"], b["depth"]) and torch.equal(a["conf"], b["conf"])
    for group in ("grads", "state"):
        assert a[group].keys() == b[group].keys()
        for k, v in a[group].items():
            assert torch.equal(v, b[group][k]), (group, k)


def test_the_profiler_cli_breakdown_names_every_span(weights, host_batch):
    model = _model()
    model.load_state_dict(weights)
    batch = shard_batch(host_batch, make_mesh(1))

    def forward():
        with torch.inference_mode():
            model.eval()(batch["imgs"], batch["proj_matrices"], batch["depth_values"])

    ms, table = profiler.breakdown(forward, reps=1)
    assert sorted(ms) == sorted(FORWARD_SPANS) and "mvsnet.forward" in table
    opt, sched = make_optimizer(model.parameters(), lambda n: 0.0)
    step = make_train_step()
    ms, _ = profiler.breakdown(lambda: step(model, opt, sched, batch), reps=1)
    assert sorted(ms) == sorted(["train.step", *PHASES, *FORWARD_SPANS])
    # no CUDA here: no device time under any span
    assert set(ms.values()) == {0.0}
