"""Where one eval forward, or one train step, spends its time on the card.

    python3 -m dmvsnet_tpu_torch.engine.profiler [--batch 2] [--warp_impl epipolar] \\
        [--tf32] [--cudnn-benchmark]
    python3 -m dmvsnet_tpu_torch.engine.profiler --train [--tf32] [--cudnn-benchmark]

Both take the model options of the CLI: ``--compute_dtype``,
``--costreg_dtype``, ``--feature_dtype`` (auto | float32 | bfloat16),
``--agg_mode`` (variance | adaptive) and, with ``--train``, ``--remat``.

Builds the DTU-eval MVSNet (864x1152, 5 views, ndepths 48/32/8, inverse
depth, seeded random weights) on CUDA and times one batch forward with
CUDA events: the whole forward, the feature net, each cost U-Net, the
cost passes (geometry, gates and kernels) and inside them each hand-written
kernel under its own name (``warp_correlate``; with ``--warp_impl
epipolar`` also ``resample`` and ``sweep1d``), the rest being sampling,
depth heads and layout copies.  Then a torch.profiler table of the kernels
by device time, and the peak device memory of a forward.

``--train`` builds the DTU-train MVSNet instead (512x640, 5 views, batch 2,
ndepths 48/32/8, inverse depth, fp32, Adam) and times train steps on one
synthetic batch: forward (model + loss), backward, optimizer, and inside
them each of the three warp-correlate kernels summed over its six
launches; then the kernel table and the peak device memory of a step.

Measures only: the port itself never sets
``--tf32`` or ``--cudnn-benchmark`` (it pins fp32 and leaves cuDNN's
algorithm choice at its default); the flags exist to measure what they
would change.
"""

from __future__ import annotations

import argparse
import json
import statistics
from collections import defaultdict

import numpy as np
import torch

from dmvsnet_tpu_torch import pin_fp32, resolve_device
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.engine.evaluate import build_model
from dmvsnet_tpu_torch.engine.state import make_lr_schedule, make_optimizer
from dmvsnet_tpu_torch.engine.train import build_model as build_train_model
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.ops import cuda_build
from dmvsnet_tpu_torch.ops import epipolar_sweep as es
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic


def _batch(cfg, batch: int, n_views: int, height: int, width: int, device) -> dict:
    """A synthetic batch on ``device`` with inverse-depth hypotheses."""
    b = synthetic.make_batch(batch=batch, n_views=n_views, height=height, width=width,
                             n_depths=cfg.numdepth)
    dv = (1.0 / np.linspace(1 / 425.0, 1 / 935.0, cfg.numdepth)).astype(np.float32)
    b["depth_values"] = np.broadcast_to(dv, (batch, cfg.numdepth)).copy()

    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return torch.from_numpy(v).to(device)

    return move(b)


def _inputs(cfg, batch: int, device):
    b = _batch(cfg, batch, cfg.num_view, cfg.max_h, cfg.max_w, device)
    return b["imgs"], b["proj_matrices"], b["depth_values"]


class _Spans:
    """CUDA-event spans by name, summed over one forward."""

    def __init__(self):
        self.events = defaultdict(list)

    def start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name].append([ev, None])

    def end(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name][-1][1] = ev

    def ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


def _timed_launches(spans: _Spans):
    """cuda_build.launch wrapped in a span named after the kernel."""
    real = cuda_build.launch

    def timed_launch(name, *args):
        spans.start(name)
        real(name, *args)
        spans.end(name)

    return real, timed_launch


def breakdown(model, inputs, reps: int = 3) -> dict[str, float]:
    """Median over `reps` forwards of each span's summed milliseconds.  The
    kernels' spans lie inside ``cost_passes``; ``other`` is the forward less
    the module and cost-pass spans."""
    spans = _Spans()
    hooks = []
    for name, mod in model.named_modules():
        if name == "feature" or name.startswith("cost_regularization") and name.count(".") == 1:
            key = "feature_net" if name == "feature" else (
                "costreg_refine" if "refine" in name else "costreg") + f"_s{int(name[-1]) + 1}"
            hooks.append(mod.register_forward_pre_hook(lambda m, a, k=key: spans.start(k)))
            hooks.append(mod.register_forward_hook(lambda m, a, o, k=key: spans.end(k)))

    def timed_pass(real):
        def run(*args, **kw):
            spans.start("cost_passes")
            out = real(*args, **kw)
            spans.end("cost_passes")
            return out
        return run

    real_exact, real_epi = wc.aggregate_cost_volume, es.aggregate_cost_volume_epipolar
    real_adaptive = wc.aggregate_cost_volume_adaptive
    real_launch, timed_launch = _timed_launches(spans)
    runs = []
    wc.aggregate_cost_volume = timed_pass(real_exact)
    wc.aggregate_cost_volume_adaptive = timed_pass(real_adaptive)
    es.aggregate_cost_volume_epipolar = timed_pass(real_epi)
    cuda_build.launch = timed_launch
    try:
        with torch.inference_mode():
            model(*inputs)
            for _ in range(reps):
                spans.events.clear()
                spans.start("forward")
                model(*inputs)
                spans.end("forward")
                runs.append(spans.ms())
    finally:
        wc.aggregate_cost_volume, es.aggregate_cost_volume_epipolar = real_exact, real_epi
        wc.aggregate_cost_volume_adaptive = real_adaptive
        cuda_build.launch = real_launch
        for h in hooks:
            h.remove()
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    out["other"] = out["forward"] - sum(
        v for k, v in out.items() if k != "forward" and k not in cuda_build.KERNELS)
    return out


def _profiled(fn, rows: int = 15) -> str:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows)


def kernel_table(model, inputs, rows: int = 15) -> str:
    with torch.inference_mode():
        return _profiled(lambda: model(*inputs), rows)


def train_breakdown(cfg, model, optimizer, scheduler, batch, reps: int = 3):
    """(median over `reps` train steps of each span's summed milliseconds,
    a function that runs one more step)."""
    spans = _Spans()
    real_launch, timed_launch = _timed_launches(spans)

    def step():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        spans.start("step")
        spans.start("forward")
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss = mvs_loss(out, batch["depth"], batch["mask"], cfg.depth_mode, tuple(cfg.dlossw))
        spans.end("forward")
        spans.start("backward")
        loss.backward()
        spans.end("backward")
        spans.start("optimizer")
        optimizer.step()
        scheduler.step()
        spans.end("optimizer")
        spans.end("step")

    runs = []
    cuda_build.launch = timed_launch
    try:
        step()
        for _ in range(reps):
            spans.events.clear()
            step()
            runs.append(spans.ms())
    finally:
        cuda_build.launch = real_launch
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}, step


def _options(args) -> dict:
    """The model options of the command line, as Config fields."""
    return dict(compute_dtype=args.compute_dtype, costreg_dtype=args.costreg_dtype,
                feature_dtype=args.feature_dtype, agg_mode=args.agg_mode)


def main_train(args, device) -> None:
    cfg = preset("dtu_train", remat=args.remat, **_options(args))
    model = build_train_model(cfg, device)
    optimizer, scheduler = make_optimizer(
        model.parameters(), make_lr_schedule(cfg.lr, 1, cfg.scheduler, cfg.warmup,
                                             cfg.milestones, cfg.lr_decay, cfg.epochs), cfg.wd)
    batch = _batch(cfg, cfg.batch_size, cfg.nviews, *cfg.img_size, device)
    times, step = train_breakdown(cfg, model, optimizer, scheduler, batch)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print("train_breakdown " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=cfg.batch_size, remat=cfg.remat,
        **_options(args), tf32=args.tf32,
        cudnn_benchmark=args.cudnn_benchmark, peak_mem_gb=peak / 1e9, ms=times)), flush=True)
    print(_profiled(step), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dmvsnet_tpu_torch.engine.profiler")
    p.add_argument("--train", action="store_true", help="break a train step down instead")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--warp_impl", default="auto", choices=["auto", "cuda", "epipolar", "torch"],
                   help="cost passes of the eval forward (epipolar: the model's routing)")
    for name in ("compute_dtype", "costreg_dtype", "feature_dtype"):
        p.add_argument(f"--{name}", default="auto", choices=["auto", "float32", "bfloat16"])
    p.add_argument("--agg_mode", default="variance", choices=["variance", "adaptive"])
    p.add_argument("--remat", action="store_true", help="with --train: rematerialise")
    p.add_argument("--tf32", action="store_true", help="measure with TF32 convolutions")
    p.add_argument("--cudnn-benchmark", action="store_true",
                   help="measure with cuDNN's algorithm search")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    pin_fp32()
    torch.backends.cudnn.allow_tf32 = args.tf32
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    if args.train:
        main_train(args, device)
        return
    cfg = preset("dtu_test", filter_method="none", eval_batch=args.batch,
                 warp_impl=args.warp_impl, **_options(args))
    model = build_model(cfg, device)
    inputs = _inputs(cfg, args.batch, device)
    times = breakdown(model, inputs)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(*inputs)
    peak = torch.cuda.max_memory_allocated()
    print("breakdown " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=args.batch, warp_impl=model.warp_impl,
        **_options(args), tf32=args.tf32, cudnn_benchmark=args.cudnn_benchmark,
        peak_mem_gb=peak / 1e9,
        ms_per_map=times["forward"] / args.batch, ms=times)), flush=True)
    print(kernel_table(model, inputs), flush=True)


if __name__ == "__main__":
    main()
