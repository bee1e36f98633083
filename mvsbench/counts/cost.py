"""The benchmark's frozen count of operations and bytes.

A copy of the program's counting rules at commit 1e68102 (the definition
of PR 11): ``engine/profiler._op_flops`` / ``_op_bytes`` / ``_CostCounter``
and ``ops/warp_correlate.pass_cost`` / ``adjoint_cost``.  Later changes to
the program's own count do not move this one.  It counts the frozen
reference (``mvsbench/reference``), whose operations are the program's
fp32 plain path op for op, so that for the same shapes it equals what the
program's ``engine/profiler.cost_analysis`` gives (held by
``mvsbench/tests/test_mvsbench_counts.py``).

* FLOPs: convolutions and matmuls at 2 per multiply-add with the padding
  taps (``torch.utils.flop_counter``'s registry), their backward where the
  call differentiates; every cost pass at ``pass_cost`` and, where its
  features need a gradient, both ``adjoint_cost`` with every tap; batch
  norm 4 per element (7 with batch statistics), its backward 8; layer and
  group norm as batch norm with batch statistics, 7 per element, their
  backward 8 (the benchmark's own rule, not the copy's: DMVSNet runs
  neither); softmax 5, its backward 4; bilinear upsampling 8; reductions 1
  per input element (variances 3); an accumulating scatter 1 per value;
  every other pointwise op 1 per output element.  Nothing else counts.
* Bytes: each op's tensor arguments and outputs at their logical size,
  except views, aliases and allocations; write-only ops their outputs;
  each cost pass its least bytes.

A cost pass is every call of ``reference.model.cost_pass`` made while the
count runs, looked up through that module at the call: a reference that
calls ``model.cost_pass`` once per (reference, source) pair is counted per
pair.  The count also records each pass's shape, in the order of the
forward calls (``Counter.passes``), which kernel 1's least time is summed
from (``warp_correlate_least_seconds``).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from mvsbench.reference import model as ref_model

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
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "alias", "_unsafe_view", "set_", "resize_",
             "record_stream", "_record_function_enter_new", "_record_function_exit"}
_WRITE_ONLY = {"zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
               "new_zeros", "new_ones", "new_full", "zero_", "fill_", "scalar_tensor",
               "arange", "zeros", "ones", "full", "linspace"}


def pass_cost(b: int, v: int, d: int, h: int, w: int, c: int) -> tuple[int, int]:
    """Least bytes (each input read once, the output written once) and fp32
    operations (10*C + 20 per pixel, plane and source view) of one cost pass
    on (B, V, H, W, C) features and D planes."""
    nbytes = 4 * (b * d * h * w + b * d * h * w * 2 + b * v * h * w * c + b * (v - 1) * 12)
    flops = b * d * h * w * (v - 1) * (10 * c + 20)
    return nbytes, flops


def adjoint_cost(b: int, v: int, d: int, h: int, w: int, c: int) -> list[tuple[int, int]]:
    """Least bytes and fp32 operations of the two adjoints of one pass
    (reference features, source features), counting every tap."""
    taps = 4 * b * d * h * w * (v - 1)
    shared = b * d * h * w * 3 + b * (v - 1) * 12
    return [
        (4 * (shared + b * (v - 1) * h * w * c + b * h * w * c),
         b * d * h * w * ((v - 1) * (8 * c + 20) + 2 * c)),
        (4 * (shared + b * h * w * c + b * (v - 1) * h * w * c),
         b * d * h * w * (2 * c + (v - 1) * 20) + taps * 2 * c),
    ]


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_flops(func, args, kwargs, out) -> tuple[str, int]:
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


class Counter(TorchDispatchMode):
    """Counts every aten op by kind while active, except inside
    ``suspend()``; ``add`` takes the cost passes' canonical counts.
    ``passes`` holds each cost pass in the order of the forward calls:
    ``{"shape": (b, v, d, h, w, c), "adjoint": bool}``, ``adjoint`` set once
    the backward has counted the pass's adjoints."""

    def __init__(self):
        super().__init__()
        self.flops: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        self.passes: list[dict] = []
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

    def add_pass(self, shape: tuple[int, ...]) -> dict:
        """Counts one cost pass's forward at ``shape`` and records it."""
        self.add("cost_pass", *pass_cost(*shape))
        entry = {"shape": shape, "adjoint": False}
        self.passes.append(entry)
        return entry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            kind, flops = _op_flops(func, args, kwargs, out)
            self.add(kind, _op_bytes(func, args, kwargs, out), flops)
        return out

    def totals(self) -> dict[str, float]:
        return {"flops": float(sum(self.flops.values())),
                "bytes_accessed": float(sum(self.bytes.values()))}


def _shape(feats: torch.Tensor, depth: torch.Tensor) -> tuple[int, ...]:
    b, v, h, w, c = feats.shape
    return b, v, depth.shape[1], h, w, c


class _CountedPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counter, feats, rel, depth):
        with counter.suspend():
            out = _PLAIN_PASS(feats, rel, depth)
        ctx.entry = counter.add_pass(_shape(feats, depth))
        ctx.counter = counter
        ctx.save_for_backward(feats, rel, depth)
        return out

    @staticmethod
    def backward(ctx, cot):
        feats, rel, depth = ctx.saved_tensors
        with ctx.counter.suspend(), torch.enable_grad():
            f = feats.detach().requires_grad_()
            (grad,) = torch.autograd.grad(_PLAIN_PASS(f, rel, depth), f, cot.contiguous())
        for cost in adjoint_cost(*ctx.entry["shape"]):
            ctx.counter.add("cost_pass_adjoint", *cost)
        ctx.entry["adjoint"] = True
        return None, grad, None, None


_PLAIN_PASS = ref_model.cost_pass


@contextlib.contextmanager
def counting():
    """Yields a ``Counter`` active over the block, with the reference's
    cost pass reporting its canonical count in place of its aten ops."""
    counter = Counter()

    def counted(feats, rel, depth):
        if torch.is_grad_enabled() and feats.requires_grad:
            return _CountedPass.apply(counter, feats, rel, depth)
        with counter.suspend():
            out = _PLAIN_PASS(feats, rel, depth)
        counter.add_pass(_shape(feats, depth))
        return out

    ref_model.cost_pass = counted
    try:
        with counter:
            yield counter
    finally:
        ref_model.cost_pass = _PLAIN_PASS


def eval_counter(model, imgs, proj, depth_values) -> Counter:
    """The count of one eval forward of the reference ``model`` on a batch
    (under ``no_grad``, the model in eval mode)."""
    model.eval()
    with torch.no_grad(), counting() as counter:
        model(imgs, proj, depth_values)
    return counter


def train_counter(model, batch: dict, loss_fn) -> Counter:
    """The count of one training forward, loss and backward of the
    reference ``model`` (train mode): ``loss_fn(outputs, batch)`` is the
    loss.  The optimizer's update is not counted."""
    model.train()
    with counting() as counter:
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss_fn(out, batch).backward()
    return counter


def warp_correlate_least_seconds(passes: list[dict], peak_flops: float, peak_bytes: float,
                                 backward: bool = False) -> float:
    """The least time of the cost passes that a count recorded
    (``Counter.passes``; forward kernel, or with ``backward`` the two adjoint
    kernels of each pass whose adjoints were counted): per pass the larger
    of its bytes over ``peak_bytes`` and its operations over ``peak_flops``,
    summed in the order of the forward calls."""
    total = 0.0
    for p in passes:
        if backward and not p["adjoint"]:
            continue
        costs = adjoint_cost(*p["shape"]) if backward else [pass_cost(*p["shape"])]
        total += sum(max(nb / peak_bytes, fl / peak_flops) for nb, fl in costs)
    return total
