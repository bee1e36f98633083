"""Where one eval forward spends its time on the card.

    python3 -m dmvsnet_tpu_torch.engine.profiler [--batch 2] [--tf32] [--cudnn-benchmark]

Builds the DTU-eval MVSNet (864x1152, 5 views, ndepths 48/32/8, inverse
depth, seeded random weights) on CUDA and times one batch forward with
CUDA events: the whole forward, the feature net, each cost U-Net, and
each cost pass (relative projections + the warp-correlate kernel), the
rest being sampling, depth heads and layout copies.  Then a
torch.profiler table of the kernels by device time, and the peak device
memory of a forward.  Measures only: the port itself never sets
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
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic


def _inputs(cfg, batch: int, device):
    b = synthetic.make_batch(batch=batch, n_views=cfg.num_view, height=cfg.max_h,
                             width=cfg.max_w, n_depths=cfg.numdepth)
    dv = (1.0 / np.linspace(1 / 425.0, 1 / 935.0, cfg.numdepth)).astype(np.float32)
    return (torch.from_numpy(b["imgs"]).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in b["proj_matrices"].items()},
            torch.from_numpy(np.broadcast_to(dv, (batch, cfg.numdepth)).copy()).to(device))


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


def breakdown(model, inputs, reps: int = 3) -> dict[str, float]:
    """Median over `reps` forwards of each span's summed milliseconds."""
    spans = _Spans()
    hooks = []
    for name, mod in model.named_modules():
        if name == "feature" or name.startswith("cost_regularization") and name.count(".") == 1:
            key = "feature_net" if name == "feature" else (
                "costreg_refine" if "refine" in name else "costreg") + f"_s{int(name[-1]) + 1}"
            hooks.append(mod.register_forward_pre_hook(lambda m, a, k=key: spans.start(k)))
            hooks.append(mod.register_forward_hook(lambda m, a, o, k=key: spans.end(k)))
    real = wc.aggregate_cost_volume

    def timed_pass(*args, **kw):
        spans.start("cost_passes")
        out = real(*args, **kw)
        spans.end("cost_passes")
        return out

    runs = []
    wc.aggregate_cost_volume = timed_pass
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
        wc.aggregate_cost_volume = real
        for h in hooks:
            h.remove()
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    out["other"] = out["forward"] - sum(v for k, v in out.items() if k != "forward")
    return out


def kernel_table(model, inputs, rows: int = 15) -> str:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        model(*inputs)
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dmvsnet_tpu_torch.engine.profiler")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--tf32", action="store_true", help="measure with TF32 convolutions")
    p.add_argument("--cudnn-benchmark", action="store_true",
                   help="measure with cuDNN's algorithm search")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    pin_fp32()
    torch.backends.cudnn.allow_tf32 = args.tf32
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    cfg = preset("dtu_test", filter_method="none", eval_batch=args.batch)
    model = build_model(cfg, device)
    inputs = _inputs(cfg, args.batch, device)
    times = breakdown(model, inputs)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(*inputs)
    peak = torch.cuda.max_memory_allocated()
    print("breakdown " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=args.batch, tf32=args.tf32,
        cudnn_benchmark=args.cudnn_benchmark, peak_mem_gb=peak / 1e9,
        ms_per_map=times["forward"] / args.batch, ms=times)), flush=True)
    print(kernel_table(model, inputs), flush=True)


if __name__ == "__main__":
    main()
