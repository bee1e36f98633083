"""Where one eval forward, or one train step, spends its time on the card.

    python3 -m dmvsnet_tpu_torch.engine.profiler [--batch 2] [--warp_impl epipolar] [--tf32]
    python3 -m dmvsnet_tpu_torch.engine.profiler --train [--tf32]

Both take the model options of the CLI: ``--compute_dtype``,
``--costreg_dtype``, ``--feature_dtype`` (auto | float32 | bfloat16),
``--agg_mode`` (variance | adaptive), ``--architecture`` (dmvsnet |
transmvsnet, eval only; TransMVSNet weights its views pixel by pixel) and,
with ``--train``, ``--remat``;
and ``--fold``, which runs the folded level-0 plan
(``MVSNet.fold_level0 = True``, ``models/folded.py``).

Builds the DTU-eval MVSNet (864x1152, 5 views, ndepths 48/32/8, inverse
depth, seeded random weights) on CUDA, or with ``--train`` the DTU-train
one (512x640, 5 views, batch 2, ndepths 48/32/8, inverse depth, fp32, Adam)
on one synthetic batch, and runs three forwards (``make_infer_step``) or
train steps (``make_train_step``) in one torch.profiler session after a
warm-up, as the program runs them: with cuDNN's algorithms chosen by
measurement (``measured_conv_algorithms``).  Prints the device ms of one
forward or step by program span (``utils/trace``: ``mvsnet.*`` per stage
and pass, ``train.*`` per phase; what each span launched, on any thread)
and by hand-written kernel (``warp_correlate``, its two adjoints, and
with ``--warp_impl epipolar`` ``resample`` and ``sweep1d``), the peak
device memory of one more, ``conv_selections`` (the convolution
problems cuDNN searched, all in the warm-up), ``fold_stats`` (the
batch-normed blocks' folded and unfolded calls and fold refreshes over the
warm-up, the session and that one more) and ``adaptive_stats`` (the
adaptive cost passes by route, gated or per pair, over the same runs),
then the session's table of ops by device time.

``--tf32`` measures only: the port itself pins fp32 (``pin_fp32``); the
flag exists to measure what TF32 convolutions would change.

Beside these tools, the JAX package's profiling API under its names
(port of dmvsnet_tpu.engine.profiler, the counterpart of the reference's
thop print): ``count_params``, ``cost_analysis`` (FLOPs and bytes of one
call, counted as its docstring defines), ``model_summary`` (both for an
eval forward: the line ``run_test`` prints once per run), ``wall_clock``
and ``device_trace`` (a torch.profiler Chrome trace).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from dmvsnet_tpu_torch import pin_fp32, resolve_device
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.engine.state import make_lr_schedule, make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_infer_step, make_train_step
from dmvsnet_tpu_torch.engine.train import build_model as build_train_model
from dmvsnet_tpu_torch.models import blocks, transmvsnet
from dmvsnet_tpu_torch.ops import cuda_build, deform_conv
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic, trace


def count_params(model: torch.nn.Module) -> int:
    """Parameters only, not buffers: the JAX package counts ``params``
    without ``batch_stats``."""
    return sum(p.numel() for p in model.parameters())


# Operations per element of the aten ops that cost_analysis counts besides
# convolutions and matmuls (see its docstring).
_BN_FORWARD = {"native_batch_norm", "cudnn_batch_norm", "miopen_batch_norm",
               "_native_batch_norm_legit", "_native_batch_norm_legit_no_training",
               "_batch_norm_with_update", "_batch_norm_no_update"}
_BN_BACKWARD = {"native_batch_norm_backward", "cudnn_batch_norm_backward",
                "miopen_batch_norm_backward", "batch_norm_backward"}
# layer and group norm normalise by statistics of their own input, as a
# batch norm in training does
_NORM = {"native_layer_norm": 7, "native_group_norm": 7, "native_layer_norm_backward": 8,
         "native_group_norm_backward": 8}
_PER_OUTPUT = {"_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
               "_log_softmax_backward_data": 4, "upsample_bilinear2d": 8,
               "upsample_bilinear2d_backward": 8}
_PER_INPUT = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1, "prod": 1,
              "argmax": 1, "argmin": 1, "var": 3, "std": 3, "var_mean": 3, "std_mean": 3}
_COPIES = {"clone", "_to_copy", "copy", "copy_", "lift_fresh_copy", "alias_copy"}
# ops that move no data: allocation, aliasing and metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "alias", "_unsafe_view", "set_", "resize_",
             "record_stream", "_record_function_enter_new", "_record_function_exit"}
# ops that write their output without reading their tensor arguments' data
_WRITE_ONLY = {"zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
               "new_zeros", "new_ones", "new_full", "zero_", "fill_", "scalar_tensor",
               "arange", "zeros", "ones", "full", "linspace"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_flops(func, args, kwargs, out) -> tuple[str, int]:
    """(kind, operations) of one aten op, as cost_analysis defines them."""
    packet, name = func.overloadpacket, func.overloadpacket.__name__
    if packet in flop_registry:
        kind = "convolution" if "conv" in name else "matmul"
        return kind, int(flop_registry[packet](*args, **kwargs, out_val=out))
    if name in _BN_FORWARD:
        training = (name == "_batch_norm_with_update"
                    or name not in ("_native_batch_norm_legit_no_training",
                                    "_batch_norm_no_update") and bool(args[5]))
        return "batch_norm", (7 if training else 4) * args[0].numel()
    if name in _BN_BACKWARD:
        return "batch_norm", 8 * args[0].numel()
    if name in _NORM:
        return "norm", _NORM[name] * args[0].numel()
    if name in _PER_OUTPUT:
        kind = "softmax" if "softmax" in name else "resample"
        return kind, _PER_OUTPUT[name] * _tensors(out)[0].numel()
    if name in _PER_INPUT:
        return "reduction", _PER_INPUT[name] * args[0].numel()
    if name in ("index_put", "index_put_"):
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return "scatter", args[2].numel() if accumulate else 0
    if name in ("index_add", "index_add_", "scatter_add", "scatter_add_"):
        return "scatter", args[3].numel()
    if torch.Tag.pointwise in func.tags and name not in _COPIES:
        return "pointwise", _tensors(out)[0].numel()
    return "other", 0


def _op_bytes(func, args, kwargs, out) -> int:
    name = func.overloadpacket.__name__
    if func.is_view or name in _NO_BYTES:
        return 0
    written = sum(t.numel() * t.element_size() for t in _tensors(out))
    if name in _WRITE_ONLY:
        return written
    read_args = (args[1:], kwargs) if name == "copy_" else (args, kwargs)
    return written + sum(t.numel() * t.element_size() for t in _tensors(read_args))


class _CostCounter(TorchDispatchMode):
    """The counter of ``cost_analysis``: a dispatch mode that counts every
    aten op outside the cost passes, and the passes' own reports
    (``ops/warp_correlate.COUNTER``), by kind."""

    def __init__(self):
        super().__init__()
        self.flops: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        self._suspended = 0

    @contextlib.contextmanager
    def suspend(self):
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def add(self, kind: str, nbytes: int, flops: int) -> None:
        self.bytes[kind] += nbytes
        self.flops[kind] += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            kind, flops = _op_flops(func, args, kwargs, out)
            self.add(kind, _op_bytes(func, args, kwargs, out), flops)
        return out


def cost_breakdown(fn: Callable, *args) -> dict[str, dict[str, int]]:
    """``cost_analysis`` of ``fn(*args)`` by kind: {"flops": {kind: n},
    "bytes_accessed": {kind: n}}, kinds "convolution", "matmul",
    "cost_pass", "cost_pass_adjoint", "batch_norm", "softmax", "resample",
    "reduction", "scatter", "pointwise" and "other" (ops that move bytes
    and count no operation: copies, gathers, concatenations, fills)."""
    counter = _CostCounter()
    if wc.COUNTER is not None:
        raise RuntimeError("cost counting does not nest")
    wc.COUNTER = counter
    try:
        with counter:
            fn(*args)
    finally:
        wc.COUNTER = None
    return {"flops": dict(counter.flops), "bytes_accessed": dict(counter.bytes)}


def cost_analysis(fn: Callable, *args) -> dict[str, float]:
    """FLOPs and bytes accessed of one call ``fn(*args)``, which runs for
    real (on the device of its tensors) under a counter; its result is
    dropped.  A real call, and not a shape-only one, because the epipolar
    route decides its pairs on the host from real values and a mesh's
    collectives need real tensors.  The count is this process's program,
    as the JAX function takes the first device program's analysis.

    * FLOPs: aten convolutions and matmuls, and their backward where ``fn``
      differentiates, at 2 per multiply-add with the taps that fall in the
      padding included, as ``torch.utils.flop_counter`` counts them; plus
      every cost pass at its canonical count, ``pass_cost`` (and both
      ``adjoint_cost``s with every tap where ``fn`` differentiates it), the
      same whatever computes the pass (``ops/warp_correlate.counted_pass``);
      plus, per element: batch norm 4 (7 with batch statistics) and its
      backward 8; layer and group norm 7 and their backward 8 (as the
      benchmark's frozen count, ``mvsbench/counts/cost.py``); softmax 5
      and its backward 4; bilinear upsampling 8; reductions 1 per input
      element (variances 3); an accumulating scatter 1 per value; every
      other pointwise op 1 per output element (comparisons and selections
      included, copies not).  Every other op counts 0.
    * Bytes: for every aten op outside the passes, except views, aliases
      and allocations, the bytes of its tensor arguments (read) and of its
      outputs (written), each at its logical size; an op that only writes
      (a fill, ``zeros_like``) counts its outputs alone; plus each pass's
      least bytes (``pass_cost`` / ``adjoint_cost``).  This is the traffic
      of an eager program in which nothing stays in cache, not XLA's
      figure for a fused program.
    * A recomputation under remat is counted again, as in XLA's program.
    """
    kinds = cost_breakdown(fn, *args)
    return {k: float(sum(v.values())) for k, v in kinds.items()}


def model_summary(model: torch.nn.Module, *example_args) -> dict[str, Any]:
    """params, FLOPs and bytes of an eval forward of ``model`` on
    ``example_args`` under ``torch.no_grad()`` (``cost_analysis``): the line
    ``run_test`` prints once per run.  The model's mode is restored."""
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            costs = cost_analysis(model, *example_args)
    finally:
        model.train(training)
    return {"params": count_params(model), **costs}


@contextlib.contextmanager
def wall_clock(label: str = "", sync: Any = None):
    """Wall-time context that prints ``label: X.XXXs``; every CUDA device
    holding a tensor of ``sync`` (any nesting of lists, tuples and dicts)
    is synchronised first."""
    t0 = time.perf_counter()
    yield
    for device in {t.device for t in _tensors(sync) if t.is_cuda}:
        torch.cuda.synchronize(device)
    print(f"{label}: {time.perf_counter() - t0:.3f}s", flush=True)


def _activities() -> list:
    """CPU activity, and CUDA activity where there is a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, CPU and (where there is one) CUDA
    activity; writes the Chrome trace ``log_dir/trace.json`` at exit
    (open it in Perfetto or chrome://tracing), in which the program's spans
    (``utils/trace``) are user annotations.  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


def synthetic_inputs(cfg, batch: int, device):
    """(imgs, proj_matrices, depth_values) of a synthetic batch at ``cfg``'s
    eval shape (``max_h`` x ``max_w``, ``num_view`` views) on ``device``."""
    b = _batch(cfg, batch, cfg.num_view, cfg.max_h, cfg.max_w, device)
    return b["imgs"], b["proj_matrices"], b["depth_values"]


def span_ms(prof, reps: int = 1) -> dict[str, float]:
    """Device milliseconds per run of ``reps`` in a finished profiler
    session ``prof``: per program span name (``utils/trace``), the kernels,
    copies and sets launched inside any of its host ranges, on any thread
    (a CUDA backward runs on autograd's own thread, outside the span tree
    of ``key_averages``); per hand-written kernel (``cuda_build.KERNELS``),
    its device time from ``key_averages``."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    launched = [(e.time_range.start, sum(k.duration for k in e.kernels)) for e in cpu
                if e.kernels]
    ranges = defaultdict(list)
    for e in cpu:
        if e.name.startswith(trace.PREFIXES):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    out = {name: sum(d for t, d in launched if any(a <= t <= b for a, b in rs)) / 1e3 / reps
           for name, rs in sorted(ranges.items())}
    for row in prof.key_averages():
        # the longest name that matches: gated_warp_correlate_kernel also
        # holds warp_correlate_kernel
        kernel = max((k for k in cuda_build.KERNELS if f"{k}_kernel" in row.key), key=len,
                     default=None)
        if kernel:
            out[kernel] = out.get(kernel, 0.0) + row.self_device_time_total / 1e3 / reps
    return out


def breakdown(run: Callable[[], Any], reps: int = 3) -> tuple[dict[str, float], str]:
    """(``span_ms`` of ``run`` (an eval forward or a train step), the
    session's table of ops by device time): one warm-up call, then one
    ``torch.profiler`` session over ``reps`` calls."""
    run()
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(reps):
            run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15)
    return span_ms(prof, reps), table


def _options(args) -> dict:
    """The model options of the command line, as Config fields."""
    return dict(compute_dtype=args.compute_dtype, costreg_dtype=args.costreg_dtype,
                feature_dtype=args.feature_dtype, architecture=args.architecture,
                agg_mode=args.agg_mode or ("pixelwise" if args.architecture == "transmvsnet"
                                           else "variance"))


def _reset_stats() -> None:
    blocks.reset_conv_selections()
    blocks.reset_fold_stats()
    wc.reset_adaptive_stats()
    transmvsnet.reset_fmt_stats()
    deform_conv.reset_stats()


def _stats() -> dict:
    return dict(conv_selections=blocks.conv_selections(), fold_stats=blocks.fold_stats(),
                adaptive_stats=wc.adaptive_stats(), fmt_stats=transmvsnet.fmt_stats(),
                deform_stats=deform_conv.stats())


def main_train(args, device) -> None:
    cfg = preset("dtu_train", remat=args.remat, **_options(args))
    model = build_train_model(cfg, device)
    model.fold_level0 = True if args.fold else None
    optimizer, scheduler = make_optimizer(
        model.parameters(), make_lr_schedule(cfg.lr, 1, cfg.scheduler, cfg.warmup,
                                             cfg.milestones, cfg.lr_decay, cfg.epochs), cfg.wd)
    batch = _batch(cfg, cfg.batch_size, cfg.nviews, *cfg.img_size, device)
    step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode)
    _reset_stats()
    times, table = breakdown(lambda: step(model, optimizer, scheduler, batch))
    torch.cuda.reset_peak_memory_stats()
    step(model, optimizer, scheduler, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print("train_breakdown " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=cfg.batch_size, remat=cfg.remat,
        **_options(args), fold_level0=model.fold_level0, tf32=args.tf32, **_stats(),
        peak_mem_gb=peak / 1e9, ms=times)), flush=True)
    print(table, flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dmvsnet_tpu_torch.engine.profiler")
    p.add_argument("--train", action="store_true", help="break a train step down instead")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--warp_impl", default="auto", choices=["auto", "cuda", "epipolar", "torch"],
                   help="cost passes of the eval forward (epipolar: the model's routing)")
    for name in ("compute_dtype", "costreg_dtype", "feature_dtype"):
        p.add_argument(f"--{name}", default="auto", choices=["auto", "float32", "bfloat16"])
    p.add_argument("--agg_mode", default=None, choices=["variance", "adaptive"],
                   help="DMVSNet's view aggregation (default variance)")
    p.add_argument("--architecture", default="dmvsnet", choices=["dmvsnet", "transmvsnet"],
                   help="eval only: transmvsnet weights views pixel by pixel")
    p.add_argument("--remat", action="store_true", help="with --train: rematerialise")
    p.add_argument("--fold", action="store_true",
                   help="run the folded level-0 plan (fold_level0=True)")
    p.add_argument("--tf32", action="store_true", help="measure with TF32 convolutions")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    pin_fp32()
    torch.backends.cudnn.allow_tf32 = args.tf32
    if args.train:
        main_train(args, device)
        return
    cfg = preset("dtu_test", filter_method="none", eval_batch=args.batch,
                 warp_impl=args.warp_impl, **_options(args))
    model = build_train_model(cfg, device).eval()
    if args.fold:
        model.fold_level0 = True
    inputs = synthetic_inputs(cfg, args.batch, device)
    infer = make_infer_step()

    def forward():
        infer(model, *inputs)

    _reset_stats()
    times, table = breakdown(forward)
    torch.cuda.reset_peak_memory_stats()
    forward()
    peak = torch.cuda.max_memory_allocated()
    print("breakdown " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=args.batch, warp_impl=model.warp_impl,
        **_options(args), fold_level0=getattr(model, "fold_level0", None), tf32=args.tf32,
        **_stats(), peak_mem_gb=peak / 1e9, ms_per_map=times["mvsnet.forward"] / args.batch,
        ms=times)), flush=True)
    print(table, flush=True)


if __name__ == "__main__":
    main()
