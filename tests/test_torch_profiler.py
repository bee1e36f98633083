"""The port's profiling API (dmvsnet_tpu_torch.engine.profiler: count_params,
cost_analysis, cost_breakdown, model_summary, wall_clock, device_trace) and
run_test's one-time params / FLOPs / bytes line, on the CPU at the shape of
tests/test_torch_slice.py (64x96, 3 views, ndepths 8/8/8, interval ratios
4/2/1, inverse depth, eval, fp32, seeded weights).

The count is defined by the port (cost_analysis's docstring), so it is held
to itself: identical FLOPs whatever runs the cost passes (the plain version,
the kernel wrapper, the epipolar route, the bf16 policies), a pass share of
exactly ``pass_cost`` per pass, a convolution share equal to an independent
per-layer count from the modules' shapes, and a train step that counts the
backward convolutions and ``adjoint_cost`` per pass on top of its forward.

Against XLA: one JAX compile, cost_analysis of the JAX package's canonical
program (``use_pallas_warp=False, fold_level0=False``, the program bench.py
counts).  Measured on this shape:

    port  1,991,341,531 = convolutions 1,933,148,160 + the rest 58,193,371
                          (6 cost passes 24,514,560, batch norm 20,957,184,
                          pointwise 9,583,645, softmax 1,935,360, reductions
                          711,102, bilinear upsampling 491,520)
    XLA   2,429,701,888 = convolutions 2,338,986,816 (XLA's rule, below)
                          + the rest 90,715,072
    ratio port / XLA = 0.81958

Both convolution counts start from the same 1,552,511,808 FLOPs of taps
that land inside the input.  torch counts every tap, 380,636,352 more in
the padding; XLA counts only taps inside the input (and, for the transposed
convolutions, only those on input rows, not on the holes of the dilation),
but the JAX package runs every 3x3x3 convolution as one dense 2-D
convolution over the depth axis folded into channels (blocks.conv3d_ddense),
whose zero band adds 786,475,008.  The rests differ by XLA's count of the
gather warp against the port's canonical pass count and by how each counts
elementwise work.  The ratio is asserted within 2% of 0.81958.

At the DTU-eval shape (864x1152, 5 views, 48/32/8; these layers' shapes
scaled to it, no forward run there), per map: torch's convolution count
492,997,902,336 (asserted: equal to the count chip_smoke.py's phase 24
printed on the card) = 439,866,532,544 inside + 53,131,369,792 padded;
XLA's rule 1,467,162,020,544 = inside + a band of 1,027,295,488,000 (at
48 planes the folded form mixes every plane with every other).  Against
the 1,552,552,951,808 FLOPs per map of BENCH_r05.json (XLA, the canonical
program), XLA's rest is 85,390,931,264; the port counts 516,976,940,778.5
per map in all (phase 24), a ratio of 0.333.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvsnet_tpu.engine import profiler as jprofiler
from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.engine import evaluate, profiler
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.ops import warp_correlate
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402

NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
H, W, V = 64, 96, 3
PARAMS = 2_673_048
XLA_RATIO, XLA_RATIO_RTOL = 0.81958, 0.02
# (C, D, h, w) of the six cost passes: per stage the main pass and the
# 4-plane refine
PASSES = [(c, d, H // s, W // s) for c, s in ((32, 4), (16, 2), (8, 1)) for d in (8, 4)]


def _model(**kw) -> MVSNet:
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True, **kw)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


@pytest.fixture(scope="module")
def batch():
    torch.set_num_threads(2)
    b = synthetic.make_batch(batch=1, n_views=3, height=H, width=W, n_depths=32)
    return {k: ({s: torch.from_numpy(x) for s, x in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in b.items()}


def _args(batch):
    return batch["imgs"], batch["proj_matrices"], batch["depth_values"]


@pytest.fixture(scope="module")
def fp32(batch):
    """The fp32 model, its eval forward's count by kind, and its convolution
    layers as the forward met them: (module, input shape, output shape)."""
    model = _model(warp_impl="torch")
    layers = []
    hooks = [m.register_forward_hook(
        lambda m, a, out: layers.append((m, tuple(a[0].shape), tuple(out.shape))))
        for m in model.modules() if isinstance(m, torch.nn.modules.conv._ConvNd)]
    with torch.no_grad():
        counts = profiler.cost_breakdown(model, *_args(batch))
    for h in hooks:
        h.remove()
    return model, counts, layers


def _torch_conv_flops(m, x, y) -> int:
    """torch.utils.flop_counter's rule from a layer's shapes: 2 per
    multiply-add, every tap, over the output (a transposed convolution: over
    its input)."""
    transposed = isinstance(m, torch.nn.modules.conv._ConvTransposeNd)
    return 2 * x[0] * math.prod(m.weight.shape) * math.prod((x if transposed else y)[2:])


def _valid_pairs(n_in, n_out, k, stride, pad_lo, dilation=1) -> int:
    """(output, tap) pairs of one axis that land on an input element: XLA's
    count (HloCostAnalysis), ``dilation`` the input dilation of a
    transposed convolution."""
    n = 0
    for t in range(k):
        for o in range(n_out):
            u = o * stride - pad_lo + t
            if u % dilation == 0 and 0 <= u // dilation < n_in:
                n += 1
    return n


def _xla_conv_flops(m, x, y, ddense: bool) -> int:
    """XLA's count of the JAX package's form of a layer: taps inside the
    input only; with ``ddense`` a 3x3x3 convolution is the dense 2-D
    convolution over (H, W) with D*Cin in and Do*Cout out channels
    (dmvsnet_tpu/models/blocks.conv3d_ddense)."""
    transposed = isinstance(m, torch.nn.modules.conv._ConvTransposeNd)
    cin, cout = (m.weight.shape[0], m.weight.shape[1]) if transposed else m.weight.shape[1::-1]
    k, axes = m.kernel_size, range(2, len(x))
    if transposed:
        pairs = [_valid_pairs(x[i], y[i], k[i - 2], 1, k[i - 2] - 1 - m.padding[i - 2],
                              m.stride[i - 2]) for i in axes]
    elif ddense and k == (3, 3, 3):
        cin, cout = cin * x[2], cout * y[2]
        pairs = [_valid_pairs(x[i], y[i], 3, m.stride[i - 2], 1) for i in (3, 4)]
    else:
        pairs = [_valid_pairs(x[i], y[i], k[i - 2], m.stride[i - 2], m.padding[i - 2])
                 for i in axes]
    return 2 * x[0] * cin * cout * math.prod(pairs)


# the DTU-eval shape, one map; and its count of convolution FLOPs per map
# on the card (chip_smoke.py phase 24)
DTU_VIEWS, DTU_H, DTU_W, DTU_NDEPTHS = 5, 864, 1152, (48, 32, 8)
DTU_CONV_FLOPS_PER_MAP = 492_997_902_336


def _at_dtu(name: str, shape: tuple) -> tuple:
    """A layer's tensor shape at this file's shape, scaled to one DTU-eval
    map: the feature net's batch is the views, a main cost U-Net's depth
    scales with its stage's planes (a refine U-Net keeps its 4), height and
    width scale with the image."""
    shape = list(shape)
    if name.startswith("feature."):
        shape[0] = shape[0] // V * DTU_VIEWS
    elif name.startswith("cost_regularization."):
        shape[2] = shape[2] * DTU_NDEPTHS[int(name.split(".")[1])] // NDEPTHS[0]
    shape[-2], shape[-1] = shape[-2] * DTU_H // H, shape[-1] * DTU_W // W
    return tuple(shape)


def test_count_params_equals_jax(fp32):
    model = fp32[0]
    params, _ = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    assert profiler.count_params(model) == jprofiler.count_params(params) == PARAMS


@pytest.mark.parametrize("options", [
    dict(warp_impl="cuda"),
    dict(warp_impl="epipolar", epipolar_main_stages=(0, 1, 2), epipolar_refine_stages=(0, 1, 2)),
    dict(warp_impl="epipolar"),
    dict(warp_impl="torch", dtype=torch.bfloat16),
    dict(warp_impl="torch", costreg_dtype=torch.bfloat16),
    dict(warp_impl="torch", feature_dtype=torch.bfloat16),
], ids=["cuda", "epipolar_all", "epipolar_default", "bf16", "bf16_costreg", "bf16_features"])
def test_flops_are_the_same_whatever_runs_the_passes(batch, fp32, options):
    summary = profiler.model_summary(_model(**options), *_args(batch))
    assert summary["params"] == PARAMS
    assert summary["flops"] == sum(fp32[1]["flops"].values())
    if options.get("dtype", torch.float32) == torch.float32 and "costreg_dtype" not in options \
            and "feature_dtype" not in options:
        # same dtypes: the same bytes too, but for the (B, V-1) flags of
        # the passes the epipolar routing leaves to the exact kernel
        assert abs(summary["bytes_accessed"] - sum(fp32[1]["bytes_accessed"].values())) <= 6 * 2


def test_pass_share_is_pass_cost_per_pass(fp32):
    counts = fp32[1]
    want = [warp_correlate.pass_cost(1, V, d, h, w, c) for c, d, h, w in PASSES]
    assert counts["flops"]["cost_pass"] == sum(f for _, f in want)
    assert counts["bytes_accessed"]["cost_pass"] == sum(b for b, _ in want)


def test_convolution_share_equals_a_per_layer_count(fp32):
    _, counts, layers = fp32
    kinds = {(type(m).__name__, tuple(m.kernel_size), tuple(m.stride)) for m, _, _ in layers}
    # 2-D and 3-D, strided, transposed and 1x1 layers are all in the count
    assert {("Conv2d", (1, 1), (1, 1)), ("Conv2d", (3, 3), (2, 2)),
            ("Conv3d", (3, 3, 3), (2, 2, 2)), ("ConvTranspose3d", (3, 3, 3), (2, 2, 2))} <= kinds
    assert counts["flops"]["convolution"] == sum(_torch_conv_flops(*layer) for layer in layers)


def test_train_step_counts_backward_convolutions_and_adjoints(batch, fp32):
    model, forward, layers = fp32
    model = _model(warp_impl="cuda").train()

    def step():
        out = model(*_args(batch))
        mvs_loss(out, batch["depth"], batch["mask"], "regression", (1.0, 1.0, 1.0)).backward()

    train = profiler.cost_breakdown(step)
    conv = sum(_torch_conv_flops(*layer) for layer in layers)
    # the backward: weight and input gradients of every layer but the
    # input gradient of the first (the images need none)
    assert train["flops"]["convolution"] == 3 * conv - _torch_conv_flops(*layers[0])
    adjoints = [cost for c, d, h, w in PASSES
                for cost in warp_correlate.adjoint_cost(1, V, d, h, w, c).values()]
    assert train["flops"]["cost_pass_adjoint"] == sum(f for _, f in adjoints)
    assert train["bytes_accessed"]["cost_pass_adjoint"] == sum(b for b, _ in adjoints)
    assert train["flops"]["cost_pass"] == forward["flops"]["cost_pass"]
    extra = sum(train["flops"].values()) - sum(forward["flops"].values())
    assert extra >= 2 * conv - _torch_conv_flops(*layers[0]) + sum(f for _, f in adjoints)


def test_ratio_to_xla_canonical_count(batch, fp32):
    model, counts, layers = fp32
    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 use_pallas_warp=False, fold_level0=False)
    xla = jprofiler.cost_analysis(
        lambda v, *a: jm.apply(v, *a), {"params": params, "batch_stats": stats},
        *(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), _args(batch))))
    port = sum(counts["flops"].values())
    conv = counts["flops"]["convolution"]
    inside = sum(_xla_conv_flops(*layer, ddense=False) for layer in layers)
    ddense = sum(_xla_conv_flops(*layer, ddense=True) for layer in layers)
    ratio = port / xla["flops"]
    print(f"port {port:,} (convolutions {conv:,}, rest {port - conv:,}; {counts['flops']})\n"
          f"XLA {xla['flops']:,.0f} (convolutions {ddense:,}, rest {xla['flops'] - ddense:,.0f})\n"
          f"taps inside {inside:,}, padded taps {conv - inside:,}, ddense band {ddense - inside:,}\n"
          f"ratio {ratio:.5f}")
    assert abs(ratio / XLA_RATIO - 1) <= XLA_RATIO_RTOL


def test_dtu_shape_decomposition(fp32):
    model, _, layers = fp32
    names = {m: n for n, m in model.named_modules()}
    dtu = [(m, _at_dtu(names[m], x), _at_dtu(names[m], y)) for m, x, y in layers]
    conv = sum(_torch_conv_flops(*layer) for layer in dtu)
    inside = sum(_xla_conv_flops(*layer, ddense=False) for layer in dtu)
    ddense = sum(_xla_conv_flops(*layer, ddense=True) for layer in dtu)
    print(f"DTU per map: convolutions {conv:,} = inside {inside:,} + padded {conv - inside:,}; "
          f"XLA's rule {ddense:,} = inside + band {ddense - inside:,}")
    assert conv == DTU_CONV_FLOPS_PER_MAP


def test_wall_clock_prints_its_line(capsys):
    x = torch.ones(4)
    with profiler.wall_clock("block", sync=[x, {"y": x}]):
        x.add_(1)
    out = capsys.readouterr().out.strip()
    assert out.startswith("block: ") and out.endswith("s")
    float(out[len("block: "):-1])


def test_device_trace_writes_a_trace(tmp_path):
    with profiler.device_trace(str(tmp_path)):
        torch.ones(64).mul(2).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_no_counter_outside_cost_analysis():
    with pytest.raises(ZeroDivisionError):
        profiler.cost_analysis(lambda: 1 / 0)
    assert warp_correlate.COUNTER is None


def test_run_test_prints_the_model_line_once(tmp_path, capsys, monkeypatch):
    synthetic.write_eval_scene(str(tmp_path / "data"), "scan1", height=H, width=W, n_views=V)
    cfg = preset("dtu_test", datapath=str(tmp_path / "data"), testlist="scan1",
                 outdir=str(tmp_path / "out"), ndepths=(8, 8, 8), max_h=H, max_w=W,
                 num_view=V, filter_method="none", eval_batch=2)
    calls = []
    real = evaluate.model_summary

    def recording(model, *args):
        calls.append((model, args, real(model, *args)))
        return calls[-1][2]

    monkeypatch.setattr(evaluate, "model_summary", recording)
    summary = evaluate.run_test(cfg, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert summary["maps"] == V and len(summary["dispatch_seconds"]) == 2
    model, args, s = calls[0]
    want = (f"params: {s['params']:,}  flops: {s['flops']:.3e}  "
            f"bytes: {s['bytes_accessed']:.3e}")
    assert len(calls) == 1 and [x for x in lines if x.startswith("params:")] == [want]
    assert lines.index(want) < min(i for i, x in enumerate(lines) if x.startswith("scan1 ["))
    assert args[0].shape == (2, V, H, W, 3) and s["params"] == PARAMS
    assert profiler.model_summary(model, *args) == s
