"""The gated adaptive cost pass (``ops/warp_correlate.aggregate_cost_volume_gated``,
the kernel ``csrc/warp_correlate_gated.cu``) and its route in the model.

On the CPU:

* the plain gated pass equals the per-pair route (``aggregate_cost_volume_adaptive``
  with ``MVSNet._gate``) on the same folded weight net, C = 8 / 16 / 32 and
  V = 2 / 3 / 11, with weights under which both ReLUs of the net clip some
  voxels and pass others: rtol 1e-6 (the same fp32 ops; on the CPU they
  round alike);
* ``AggWeightNetVolume.gate_params``: the folded blocks packed as
  ``w00, w01, b0, a1, b1``, kept while the weights stay, formed anew after
  ``load_state_dict``; None where a block does not fold;
* the route follows what the model can observe: an fp32 eval forward with
  autograd off counts gated passes only (``adaptive_stats``); with
  autograd on, in train mode, under the bf16 compute policy and under the
  cost count every pass runs pair by pair; features with C outside
  ``warp_correlate.CHANNELS`` run pair by pair too;
* the model's adaptive eval forward through the gated route equals the same
  forward forced onto the per-pair route: the first cost volume within
  rtol 1e-6, depth within 0.01 mm and confidence within 1e-4 (the JAX
  parity bounds of tests/test_torch_adaptive.py; a one-ulp difference in a
  later cost volume moves the random-weight map by up to ~1e-3 mm);
* the wrapper's CPU path is the plain version, and it refuses a gate of
  the wrong shape.

On the card (``cuda``): the kernel against its plain version and against
the per-pair kernel route, C = 8 / 16 / 32, batch 2, D not a multiple of
the plane group, an image whose lane groups leave a tail block, V = 2 and
11, at kernel 1's bound 1e-4 * max(1, |plain|); one launch per pass; and
the model's fp32 eval forward launching the gated kernel once per pass and
kernel 1 never.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dmvsnet_tpu_torch.engine import profiler
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import eval_affine, init_weights
from dmvsnet_tpu_torch.models.cost_reg import AggWeightNetVolume
from dmvsnet_tpu_torch.ops import cuda_build
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic

NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
H, W, V = 32, 64, 3
PASSES = 6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def counts_from_zero():
    wc.reset_adaptive_stats()
    yield
    wc.reset_adaptive_stats()


def _clipping_net(net: AggWeightNetVolume) -> AggWeightNetVolume:
    """Sets ``net``'s weights and eval statistics so that its first ReLU
    clips where ``0.8 c0 - 0.6 c1`` is below ~0.05 and its second where the
    hidden value is below ~0.3: on correlations of unit-variance features
    both clip some voxels and pass others."""
    with torch.no_grad():
        net.w0.conv.weight.copy_(torch.tensor([0.8, -0.6]).view(1, 2, 1, 1, 1))
        net.w1.conv.weight.fill_(1.5)
        for bn, (gamma, beta, mean, var) in ((net.w0.bn, (1.2, 0.05, 0.1, 0.8)),
                                             (net.w1.bn, (0.9, -0.2, 0.3, 1.1))):
            bn.weight.fill_(gamma)
            bn.bias.fill_(beta)
            bn.running_mean.fill_(mean)
            bn.running_var.fill_(var)
    return net.eval()


@pytest.fixture(scope="module")
def gating():
    """A model (for ``MVSNet._gate``) and its first weight net, set to clip."""
    model = MVSNet(ndepths=NDEPTHS, agg_mode="adaptive").eval()
    return model, _clipping_net(model.agg_weight[0])


def _pass(rng, c: int, v: int, b: int = 2, h: int = 12, w: int = 20, d: int = 5,
          device="cpu"):
    """(feats, proj2, depth) of one pass: unit-variance features, the
    "translate" cameras, per-pixel hypotheses over 300..900."""
    feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32))
    cams = synthetic.camera_set("translate", v, h, w)
    proj2 = torch.from_numpy(np.broadcast_to(cams, (b, *cams.shape)).astype(np.float32))
    dv = torch.from_numpy(np.sort(rng.uniform(300, 900, (b, d, h, w)), axis=1).astype(np.float32))
    return feats.to(device), proj2.to(device), dv.to(device)


def _per_pair(model, net, feats, proj2, dv, impl="torch"):
    return wc.aggregate_cost_volume_adaptive(
        feats, proj2, dv, lambda sim: model._gate("gate", net, sim), impl)


@pytest.mark.parametrize("views", [2, 3, 11])
@pytest.mark.parametrize("channels", [8, 16, 32])
def test_plain_gated_pass_equals_the_per_pair_route(rng, gating, channels, views):
    model, net = gating
    feats, proj2, dv = _pass(rng, channels, views)
    with torch.no_grad():
        gate = net.gate_params()
        got = wc.aggregate_cost_volume_gated(feats, proj2, dv, gate, impl="torch")
        want = _per_pair(model, net, feats, proj2, dv)
        # both ReLUs clip some voxels and pass others
        w00, w01, b0, a1, b1 = gate.tolist()
        corr = wc.warp_correlate_plain(*wc.pass_inputs(feats[:, :2], proj2[:, :2], dv))
        h = w00 * corr[..., 0] + w01 * corr[..., 1] + b0
        z = a1 * torch.relu(h) + b1
    for pre in (h, z):
        assert 0.05 < float((pre < 0).float().mean()) < 0.95
    assert got.shape == want.shape == (2, 5, 12, 20, 2) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert wc.adaptive_stats() == {"gated": 1, "per_pair": 1}


def test_gate_params_pack_the_folded_blocks_and_follow_the_weights(gating):
    model, net = gating
    with torch.no_grad():
        gate = net.gate_params()
        s0, t0 = eval_affine(net.w0.bn)
        s1, t1 = eval_affine(net.w1.bn)
        want = torch.cat([net.w0.conv.weight.reshape(2) * s0, t0,
                          net.w1.conv.weight.reshape(1) * s1, t1])
        torch.testing.assert_close(gate, want, rtol=0, atol=0)
        assert net.gate_params() is gate  # kept while the weights stay
        state = {k: v.clone() for k, v in net.state_dict().items()}
        state["w1.bn.running_var"].fill_(2.0)
        net.load_state_dict(state)
        again = net.gate_params()
        assert again is not gate and float(again[3]) != float(gate[3])
        _clipping_net(net)
    # no gate where a block does not fold: autograd on, train mode
    assert net.gate_params() is None
    with torch.no_grad():
        net.train()
        assert net.gate_params() is None
        net.eval()


def _model(**kw) -> MVSNet:
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   agg_mode="adaptive", **kw)
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    return model


@pytest.fixture(scope="module")
def batch():
    b = synthetic.make_batch(batch=1, n_views=V, height=H, width=W, n_depths=32)
    return (torch.from_numpy(b["imgs"]),
            {k: torch.from_numpy(v) for k, v in b["proj_matrices"].items()},
            torch.from_numpy(b["depth_values"]))


ROUTES = {"eval": {"gated": PASSES, "per_pair": 0},
          "grad": {"gated": 0, "per_pair": PASSES},
          "train": {"gated": 0, "per_pair": PASSES},
          "bf16": {"gated": 0, "per_pair": PASSES},
          "count": {"gated": 0, "per_pair": PASSES},
          "c4": {"gated": 4, "per_pair": 2}}


@pytest.mark.parametrize("case", list(ROUTES))
def test_the_route_follows_autograd_mode_dtype_and_count(batch, case):
    """``eval``: fp32, eval mode, autograd off; ``grad``: the same with
    autograd on; ``train``: train mode, autograd off; ``bf16``: the bf16
    compute policy in eval; ``count``: the eval forward under
    ``engine/profiler.cost_analysis``; ``c4``: base channels 4, so stage 3's
    features have C = 4 and its two passes run pair by pair."""
    model = _model(dtype=torch.bfloat16 if case == "bf16" else torch.float32,
                   base_channels=4 if case == "c4" else 8)
    model.train(case == "train")
    if case == "count":
        with torch.no_grad():
            profiler.cost_analysis(model, *batch)
    else:
        with torch.enable_grad() if case == "grad" else torch.no_grad():
            model(*batch)
    assert wc.adaptive_stats() == ROUTES[case]


def test_gated_forward_equals_the_per_pair_forward(batch, monkeypatch):
    model = _model().eval()

    def forward(run_stages=0):
        model.run_stages = run_stages
        with torch.no_grad():
            out = model(*batch)
        return out["partial"] if run_stages else out

    gated, gated_cost = forward(), forward(0.4)
    assert wc.adaptive_stats() == {"gated": PASSES + 1, "per_pair": 0}
    monkeypatch.setattr(AggWeightNetVolume, "gate_params", lambda self: None)
    pairs, pairs_cost = forward(), forward(0.4)
    assert wc.adaptive_stats() == {"gated": PASSES + 1, "per_pair": PASSES + 1}
    torch.testing.assert_close(gated_cost, pairs_cost, rtol=1e-6, atol=1e-7)
    assert torch.isfinite(gated["depth"]).all()
    assert (gated["depth"] - pairs["depth"]).abs().max().item() <= 0.01
    assert (gated["photometric_confidence"]
            - pairs["photometric_confidence"]).abs().max().item() <= 1e-4


def test_gated_wrapper_cpu_path_is_the_plain_version(rng, gating):
    _, net = gating
    feats, proj2, dv = _pass(rng, 16, 4)
    feats, rel, dv = wc.pass_inputs(feats, proj2, dv)
    with torch.no_grad():
        gate = net.gate_params()
        got = wc.gated_warp_correlate(feats, rel, dv, gate)
        want = wc.gated_warp_correlate_plain(feats, rel, dv, gate)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="gate"):
        wc.gated_warp_correlate(feats, rel, dv, gate[:4])
    with pytest.raises(ValueError, match="gate"):
        wc.gated_warp_correlate(feats, rel, dv, gate.double())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("views", [2, 11])
@pytest.mark.parametrize("channels", [8, 16, 32])
def test_gated_kernel_matches_plain_and_per_pair_on_card(rng, channels, views):
    """Batch 2, D = 5 and 11 (not multiples of the plane group, 4 or 8), a
    17 x 23 image (its lane groups leave a tail block), hypotheses that
    reach zero and negative depths; against the plain version and the
    per-pair kernel route at 1e-4 * max(1, |plain|), one launch a pass."""
    dev = _card()
    model = MVSNet(ndepths=NDEPTHS, agg_mode="adaptive").to(dev).eval()
    net = _clipping_net(model.agg_weight[0])
    for d in (5, 11):
        feats, proj2, dv = _pass(rng, channels, views, h=17, w=23, d=d, device=dev)
        dv[:, 0, 0, :4] = 0.0  # the z == 0 guard
        dv[:, -1, 1, :6] = -50.0
        with torch.no_grad():
            gate = net.gate_params()
            cuda_build.reset_launches()
            got = wc.aggregate_cost_volume_gated(feats, proj2, dv, gate)
            torch.cuda.synchronize()
            launches = cuda_build.launches()
            plain = wc.aggregate_cost_volume_gated(feats, proj2, dv, gate, impl="torch")
            pairs = _per_pair(model, net, feats, proj2, dv, impl="cuda")
            torch.cuda.synchronize()
        assert launches == {**dict.fromkeys(launches, 0), "gated_warp_correlate": 1}
        tol = 1e-4 * max(1.0, plain.abs().max().item())
        assert (got - plain).abs().max().item() <= tol, d
        assert (got - pairs).abs().max().item() <= tol, d


@pytest.mark.cuda
def test_the_model_launches_the_gated_kernel_once_a_pass_on_card(batch):
    dev = _card()
    model = _model().to(dev).eval()
    imgs, proj, dv = batch
    args = (imgs.to(dev), {k: t.to(dev) for k, t in proj.items()}, dv.to(dev))
    cuda_build.reset_launches()
    with torch.inference_mode():
        out = model(*args)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    assert launches == {**dict.fromkeys(launches, 0), "gated_warp_correlate": PASSES}
    assert wc.adaptive_stats() == {"gated": PASSES, "per_pair": 0}
    assert torch.isfinite(out["depth"]).all()
