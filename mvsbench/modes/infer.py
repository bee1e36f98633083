"""Mode ``infer``: depth-map inference as ``--test`` runs it, closed loop.

Set-up builds the eval model with ``engine.evaluate.build_model``, loads
the benchmark's seeded weights, makes the cell's pool of scenes in host
memory and warms up with two dispatches of the cell's one shape.  Each
dispatch of the window is ``run_test``'s: the host arrays of one batch to
the device, ``engine.steps.make_infer_step()``, depth and confidence back
to host arrays.  The window cycles through the pool's batches.

What a model must give this mode, whatever its architecture:
``model(imgs, proj_matrices, depth_values)`` returns a dict with ``depth``
and ``photometric_confidence`` (what ``make_infer_step`` hands back) and,
for each stage k = 1 .. len(ndepths), ``stage{k}`` holding that stage's
``depth`` (B, H_k, W_k) and ``prob_volume``; the last stage's depth is the
final one.  The configuration's reference returns the same keys.  The
traced run spans ``feature`` and the cost regularisation modules where the
model has them (``spans``).

What is compared with the configuration's reference
(``harness.reference_module``: ``mvsbench/reference``, fp32, TF32 off, on
the same weights and inputs) once the window has closed: the final
depth of every dispatch of the window, and each stage's depth and
probability volume of the last dispatch of each batch (a forward hook keeps
references to them; it does no device work).

* ``depth_mean_mm``: the largest, over those maps, of a map's mean
  |depth - reference| (mm);
* ``prob``: the largest |probability - reference| over the stages' volumes.

Neither the largest single-pixel depth gap nor the confidence is a compared
number: with the seeded weights the probability volumes are nearly flat,
so a regressed depth moves little with precision, and the largest pixel gap
of the fp32 program sits at float32's rounding of depth itself (12 ulp at
600 mm), within 3x of the bf16 control's; and the four regressed depths of
a pixel lie far closer together than the stage's interval, so the
confidence, 2 (sigmoid(interval / std) - 0.5), is 1 to rounding on both
sides.  A map's mean gap and the probabilities separate the two by 30-80x
(PERF.md).
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from mvsbench import harness, program, weights
from mvsbench.counts import cost as counts
from mvsbench.traffic import scenes

KIND = "infer"
SCENE_SEED_OFFSET = 1_000_003


def setup(ctx):
    program.package()
    from dmvsnet_tpu_torch.engine import evaluate, steps
    from dmvsnet_tpu_torch.ops import cuda_build

    marks = [("start", time.perf_counter())]
    cfg = program.config(ctx)
    device = program.device(ctx)
    w = ctx.workload
    model = evaluate.build_model(cfg, device)
    sd = weights.generate(model.state_dict(), ctx.seed, device)
    model.load_state_dict(sd)
    marks.append(("model", time.perf_counter()))
    num_stage = len(cfg.ndepths)
    pool = scenes.pool(ctx.seed + SCENE_SEED_OFFSET, w["traffic"], w["views"], w["height"],
                       w["width"], num_stage, cfg.numdepth, device)
    count = len(pool) // math.gcd(len(pool), w["batch"])
    state = SimpleNamespace(
        ctx=ctx, device=device, model=model, sd=sd, infer=steps.make_infer_step(),
        batches=scenes.batches(pool, w["batch"], count), k=0, current=0, times=[],
        answers=[], last={}, cuda_build=cuda_build, num_stage=num_stage, marks=marks)
    marks.append(("scenes", time.perf_counter()))

    def keep(_module, _args, out):
        state.last[state.current] = {
            s: (out[s]["depth"], out[s]["prob_volume"])
            for s in (f"stage{i + 1}" for i in range(num_stage))}

    model.register_forward_hook(keep)
    for _ in range(2):
        iterate(state)
    marks.append(("warm_up", time.perf_counter()))
    cuda_build.reset_launches()
    state.k, state.times, state.answers = 0, [], []
    return state


def iterate(state) -> None:
    """One dispatch, host arrays to host arrays (``run_test``'s)."""
    b = state.k % len(state.batches)
    state.current = b
    host = state.batches[b]
    t0 = time.perf_counter()
    imgs = torch.from_numpy(host["imgs"]).to(state.device)
    proj = {k: torch.from_numpy(v).to(state.device) for k, v in host["proj_matrices"].items()}
    dv = torch.from_numpy(host["depth_values"]).to(state.device)
    depth, conf = state.infer(state.model, imgs, proj, dv)
    depth = depth.cpu().numpy()
    conf = conf.cpu().numpy()
    state.times.append(time.perf_counter() - t0)
    state.answers.append((b, depth))
    state.k += 1


def drain(state) -> None:
    """Each dispatch ends in its host copies: nothing is left in flight."""


def units(state) -> int:
    return len(state.answers) * state.ctx.workload["batch"]


def end_to_end(state, window_s: float) -> dict:
    return {"maps_per_s": units(state) / window_s,
            "dispatch_p90_ms": float(np.percentile(np.array(state.times) * 1e3, 90))}


def info(state) -> dict:
    maps = units(state)
    launches = state.cuda_build.launches()
    return {"dispatches": len(state.answers),
            "dispatch_ms_median": float(np.median(state.times) * 1e3) if state.times else None,
            "launches_per_map": {k: v / maps for k, v in launches.items() if v} if maps else {},
            "build_s": state.cuda_build.BUILD_INFO["seconds"], 
            "setup_phases_s": {m[0]: m[1] - p[1] for p, m in zip(state.marks, state.marks[1:])}}


def spans(state, spans, stack) -> None:
    """Spans around what the model has: ``feature`` and every module of
    ``cost_regularization`` and ``cost_regularization_refine`` where it
    has them, and the port's ``aggregate_cost_volume``."""
    from dmvsnet_tpu_torch.ops import warp_correlate

    from mvsbench.spans import module_span, wrap

    model = state.model
    if hasattr(model, "feature"):
        module_span(model.feature, spans, "feature", stack)
    for name in ("cost_regularization", "cost_regularization_refine"):
        for reg in getattr(model, name, ()):
            module_span(reg, spans, "costreg", stack)
    wrap(warp_correlate, "aggregate_cost_volume", spans, "cost_pass", stack)


def _build_reference(ctx, device):
    return harness.reference_module(ctx.config, ctx.bench_dir).build(ctx.config, device)


def _reference(state):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = _build_reference(state.ctx, state.device)
    ref.load_state_dict(state.sd)
    return ref.eval()


def _inputs(state, host):
    to = lambda a: torch.from_numpy(a).to(state.device)  # noqa: E731
    return (to(host["imgs"]), {k: to(v) for k, v in host["proj_matrices"].items()},
            to(host["depth_values"]))


def count(state) -> tuple[float, list[dict]]:
    """The frozen count of operations per map at the cell's shapes, on the
    meta device, and the cost passes of one dispatch."""
    host = state.batches[0]
    ref = _build_reference(state.ctx, "meta")
    meta = lambda a: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,  # noqa: E731
                                 device="meta")
    imgs = meta(host["imgs"])
    proj = {k: meta(v) for k, v in host["proj_matrices"].items()}
    counter = counts.eval_counter(ref, imgs, proj, meta(host["depth_values"]))
    return counter.totals()["flops"] / state.ctx.workload["batch"], counter.passes


def check(state) -> tuple[dict, int]:
    limits = state.ctx.workload["limits"]
    last = {b: {s: tuple(t.cpu().numpy() for t in ts) for s, ts in v.items()}
            for b, v in state.last.items()}
    state.last.clear()
    state.model = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(state)
    gaps = {"depth_mean_mm": 0.0, "prob": 0.0}
    failed = 0
    for b, host in enumerate(state.batches):
        with torch.no_grad():
            out = ref(*_inputs(state, host))
        want = {s: (out[s]["depth"].cpu().numpy(), out[s]["prob_volume"].cpu().numpy())
                for s in (f"stage{i + 1}" for i in range(state.num_stage))}
        del out
        final = want[f"stage{state.num_stage}"][0]
        for bi, depth in state.answers:
            if bi != b:
                continue
            per_map = np.abs(depth - final).reshape(len(depth), -1).mean(1, dtype=np.float64)
            gaps["depth_mean_mm"] = max(gaps["depth_mean_mm"], float(per_map.max()))
            failed += int((per_map > limits["depth_mean_mm"]).sum())
        bad = False
        for s, (depth, prob) in last.get(b, {}).items():
            per_map = np.abs(depth - want[s][0]).reshape(len(depth), -1).mean(1, dtype=np.float64)
            g = {"depth_mean_mm": float(per_map.max()),
                 "prob": float(np.abs(prob - want[s][1]).max())}
            gaps = {k: max(gaps[k], g[k]) for k in gaps}
            bad |= any(g[k] > limits[k] for k in g)
        failed += state.ctx.workload["batch"] if bad else 0
    return gaps, min(failed, units(state))
