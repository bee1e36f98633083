"""The eval batch norm folded into the convolution of an fp32 block
(``dmvsnet_tpu_torch.models.blocks._Block``), on the CPU at small shapes:

* output: for ``ConvBlock`` / ``DeconvBlock``, 2-D / 3-D, with and without
  ReLU, and norms away from the identity, the folded eval output is the
  conv, the norm and the ReLU run one after the other, within fp32
  rounding;
* stale cache: the fold follows ``load_state_dict`` after ``.eval()``, a
  train step followed by ``.eval()``, ``.to()`` and a ``Module._apply``
  that changes the values (what ``.to()`` does on a device move);
* paths that must not change: a bf16 block, eval with autograd on, train
  mode and a call under the cost count run the conv, the norm and the ReLU,
  bit for bit;
* the state dict: its keys, the parameters and the buffers are those of a
  block that never folded;
* the counter: ``blocks.fold_stats()`` counts folded and unfolded calls of
  batch-normed blocks and refreshes, for two blocks and for the whole
  model's eval step under the unfolded and the folded level-0 plan
  (``fold_level0``);
* on the card (``cuda``): the folded blocks, whose non-transposed
  convolutions with ReLU run cuDNN's fused convolution-bias-ReLU, against
  the conv, the norm and the ReLU one after the other, and against the
  folded convolution followed by the ReLU in place.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dmvsnet_tpu_torch import CONV_CANDIDATES, measured_conv_algorithms
from dmvsnet_tpu_torch.engine.steps import make_infer_step
from dmvsnet_tpu_torch.models import MVSNet, blocks
from dmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock, init_weights
from dmvsnet_tpu_torch.models.cost_reg import AggWeightNetVolume
from dmvsnet_tpu_torch.ops import warp_correlate
from dmvsnet_tpu_torch.parallel import make_mesh, shard_batch
from dmvsnet_tpu_torch.utils import synthetic

KINDS = {"conv": ConvBlock, "deconv": DeconvBlock}
SHAPES = {2: (2, 3, 6, 8), 3: (2, 3, 4, 6, 8)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def counts_from_zero():
    blocks.reset_fold_stats()
    yield
    blocks.reset_fold_stats()


def _block(kind: str, dims: int, relu: bool = True, dtype=torch.float32, seed: int = 0):
    """A block with seeded conv weights and a norm away from the identity:
    gamma in [0.5, 1.5], beta in [-0.5, 0.5], running mean in [-0.5, 0.5],
    running var in [0.5, 1.5]."""
    block = KINDS[kind](3, 5, dims=dims, relu=relu, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    init_weights(block, g)
    bn = block.bn
    with torch.no_grad():
        for t, lo in ((bn.weight, 0.5), (bn.bias, -0.5), (bn.running_mean, -0.5),
                      (bn.running_var, 0.5)):
            t.copy_(torch.rand(t.shape, generator=g) + lo)
    return block


def _input(dims: int, seed: int = 1) -> torch.Tensor:
    return torch.randn(SHAPES[dims], generator=torch.Generator().manual_seed(seed))


def _present(block, x: torch.Tensor) -> torch.Tensor:
    """The block as three steps: conv, the norm (fp32), the ReLU."""
    y = block.bn(block.conv(x).float())
    if not block.training:
        y = y.to(block.dtype)
    return torch.relu(y) if block.relu else y


def _folded_eval(block, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return block(x)


def _present_eval(block, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return _present(block, x)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_folded_eval_output_is_conv_norm_relu(kind, dims, relu):
    block = _block(kind, dims, relu).eval()
    x = _input(dims)
    got = _folded_eval(block, x)
    assert blocks.fold_stats() == {"folded": 1, "unfolded": 0, "refreshes": 1}
    want = _present_eval(block, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if relu:
        assert (got >= 0).all() and (got == 0).any()
    else:
        assert (got < 0).any()
    # under inference_mode, as the port's eval dispatch runs, the same
    with torch.inference_mode():
        torch.testing.assert_close(block(x), want, rtol=1e-5, atol=1e-6)
    assert blocks.fold_stats() == {"folded": 2, "unfolded": 0, "refreshes": 1}


def _train_step(block, x: torch.Tensor) -> None:
    """One SGD step in train mode: the weights and the running statistics
    change in place."""
    block.train()
    block(x).square().mean().backward()
    with torch.no_grad():
        for p in block.parameters():
            p -= 0.5 * p.grad
    block.eval()


def _change(block, kind: str, how: str, x: torch.Tensor) -> None:
    if how == "load_state_dict":
        block.load_state_dict(_block(kind, x.dim() - 2, seed=7).state_dict())
    elif how == "train_step":
        _train_step(block, x)
    elif how == "to":
        # new storage for every tensor, the same values
        block.to(torch.float64).to(torch.float32)
    elif how == "apply":
        # what .to() does on a device move (parameters' .data and buffers
        # replaced), here with other values
        block._apply(lambda t: t * 1.25 if t.is_floating_point() else t)


@pytest.mark.parametrize("how", ["load_state_dict", "train_step", "to", "apply"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_fold_follows_new_weights_and_statistics(kind, how):
    dims = 3
    x = _input(dims)
    block = _block(kind, dims).eval()
    before = _folded_eval(block, x)
    _change(block, kind, how, x)
    blocks.reset_fold_stats()
    got = _folded_eval(block, x)
    assert blocks.fold_stats() == {"folded": 1, "unfolded": 0, "refreshes": 1}
    want = _present_eval(block, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if how != "to":
        assert not torch.allclose(before, got, rtol=1e-3, atol=1e-4)
    # and keeps it while nothing changes
    _folded_eval(block, x)
    assert blocks.fold_stats() == {"folded": 2, "unfolded": 0, "refreshes": 1}


def test_an_in_place_write_to_a_statistic_refreshes_the_fold():
    block = _block("conv", 2).eval()
    x = _input(2)
    _folded_eval(block, x)
    with torch.no_grad():
        block.bn.running_var.mul_(2.0)
    got = _folded_eval(block, x)
    assert blocks.fold_stats()["refreshes"] == 2
    torch.testing.assert_close(got, _present_eval(block, x), rtol=1e-5, atol=1e-6)


@pytest.fixture
def counting(monkeypatch):
    """A cost count running (``engine/profiler.cost_analysis`` sets one)."""
    monkeypatch.setattr(warp_correlate, "COUNTER", object())


@pytest.mark.parametrize("path", ["bf16", "grad", "train", "counted"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_other_paths_run_conv_norm_relu_bit_for_bit(kind, dims, path, request):
    if path == "counted":
        request.getfixturevalue("counting")
    dtype = torch.bfloat16 if path == "bf16" else torch.float32
    block = _block(kind, dims, dtype=dtype)
    block.train(path == "train")
    twin = copy.deepcopy(block)
    x = _input(dims)
    with torch.set_grad_enabled(path in ("grad", "train")):
        got = block(x)
        want = _present(twin, x)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert blocks.fold_stats() == {"folded": 0, "unfolded": 1, "refreshes": 0}
    assert block._fold is None
    if path == "train":
        # the running statistics took the same update
        for a, b in zip(block.buffers(), twin.buffers()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_state_dict_is_that_of_a_block_that_never_folded(kind):
    block = _block(kind, 3).eval()
    never = copy.deepcopy(block)
    _folded_eval(block, _input(3))
    assert block._fold is not None
    sd, want = block.state_dict(), never.state_dict()
    assert list(sd) == list(want)
    for k in want:
        assert torch.equal(sd[k], want[k])
    assert [n for n, _ in block.named_parameters()] == [n for n, _ in never.named_parameters()]
    assert [n for n, _ in block.named_buffers()] == [n for n, _ in never.named_buffers()]
    # a state dict saved after the fold loads into a fresh block
    fresh = KINDS[kind](3, 5, dims=3)
    fresh.load_state_dict(sd)


def test_fold_stats_count_calls_and_refreshes():
    net = AggWeightNetVolume().eval()  # two batch-normed 1x1x1 blocks
    init_weights(net, torch.Generator().manual_seed(3))
    plain = ConvBlock(2, 1, kernel=1, dims=3, bn=False).eval()  # no norm: not counted
    x = _input(3)[:, :2]
    with torch.no_grad():
        for _ in range(3):
            net(x)
            plain(x)
    assert blocks.fold_stats() == {"folded": 6, "unfolded": 0, "refreshes": 2}
    with torch.enable_grad():
        net(x)
    assert blocks.fold_stats() == {"folded": 6, "unfolded": 2, "refreshes": 2}
    blocks.reset_fold_stats()
    assert blocks.fold_stats() == {"folded": 0, "unfolded": 0, "refreshes": 0}


def _model_batch():
    model = MVSNet(ndepths=(8, 8, 8), depth_interval_ratio=(4, 2, 1), inverse_depth=True,
                   warp_impl="cuda")
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    host = synthetic.make_batch(batch=1, n_views=3, height=32, width=64, n_depths=32)
    rng = np.random.default_rng(0)
    host["imgs"] = (host["imgs"] + rng.normal(0, 0.02, host["imgs"].shape)).astype(np.float32)
    batch = shard_batch(host, make_mesh(1))
    return model.eval(), (batch["imgs"], batch["proj_matrices"], batch["depth_values"])


@pytest.mark.parametrize("plan", ["unfolded", "folded"])
def test_the_eval_step_folds_every_batch_normed_block_once(plan):
    """Under either level-0 plan (``fold_level0``): the folded plan hands
    its blocks its folded convolutions, and their norms fold as well."""
    model, args = _model_batch()
    if plan == "folded":
        model.fold_level0 = True
    normed = [m for m in model.modules() if isinstance(m, blocks._Block) and m.bn is not None]
    infer = make_infer_step()
    depth, conf = infer(model, *args)
    first = blocks.fold_stats()
    assert first["unfolded"] == 0
    assert first["refreshes"] == len(normed) and first["folded"] >= len(normed)
    assert all(m._fold is not None for m in normed)
    infer(model, *args)
    assert blocks.fold_stats() == {"folded": 2 * first["folded"], "unfolded": 0,
                                   "refreshes": len(normed)}
    # the same forward with autograd on runs every block unfolded
    with torch.enable_grad():
        out = model(*args)
    assert blocks.fold_stats()["unfolded"] == first["folded"]
    torch.testing.assert_close(depth, out["depth"].detach(), rtol=1e-5, atol=1e-3)


def _exact(block, x: torch.Tensor) -> torch.Tensor:
    """The block's eval output in float64: conv, norm, ReLU."""
    conv, bn = block.conv, block.bn
    d = x.dim() - 2
    shape = (1, -1) + (1,) * d
    if isinstance(conv, blocks._Transpose):
        fn = (F.conv_transpose2d, F.conv_transpose3d)[d - 2]
        y = fn(x.double(), conv.weight.double(), None, conv.stride, conv.padding,
               conv.output_padding)
    else:
        fn = (F.conv2d, F.conv3d)[d - 2]
        y = fn(x.double(), conv.weight.double(), None, conv.stride, conv.padding)
    scale = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    y = ((y - bn.running_mean.double().view(shape)) * scale.view(shape)
         + bn.bias.double().view(shape))
    return torch.relu(y) if block.relu else y


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_folded_blocks_on_card(kind, dims, relu):
    """At (2, 8, 16, 64, 96) (3-D) or (2, 8, 64, 96) (2-D), 8 -> 16
    channels, algorithms chosen by measurement as in the port's steps: the
    folded block (fused on the card where the conv is not transposed and
    has a ReLU) and the folded conv followed by ``relu_`` are as close to
    the float64 result as the conv, the norm and the ReLU one after the
    other: within twice its largest error, plus 1e-6 (cuDNN's algorithms
    round differently from problem to problem)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests check the folded form")
    dev = torch.device("cuda")
    block = KINDS[kind](8, 16, dims=dims, relu=relu)
    g = torch.Generator().manual_seed(5)
    init_weights(block, g)
    with torch.no_grad():
        bn = block.bn
        for t, lo in ((bn.weight, 0.5), (bn.bias, -0.5), (bn.running_mean, -0.5),
                      (bn.running_var, 0.5)):
            t.copy_(torch.rand(t.shape, generator=g) + lo)
    block = block.to(dev).eval()
    x = torch.randn((2, 8) + (16, 64, 96)[3 - dims:], generator=g).to(dev)
    with measured_conv_algorithms(CONV_CANDIDATES), torch.inference_mode():
        got = block(x)
        want = _present(block, x)
        unfused = block.conv(x, block._folded())
        if relu:
            unfused = torch.relu_(unfused)
        exact = _exact(block, x)
    torch.cuda.synchronize()
    assert blocks.fold_stats() == {"folded": 1, "unfolded": 0, "refreshes": 1}
    noise = (want.double() - exact).abs().max().item()
    for y in (got, unfused):
        assert y.dtype == torch.float32
        assert (y.double() - exact).abs().max().item() <= 2 * noise + 1e-6
