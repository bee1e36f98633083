"""TransMVSNet in the port (``models/transmvsnet.py``, ``ops/deform_conv.py``,
the uniform hypotheses of ``core/sampling.py``, the pixel-wise cost pass of
``ops/warp_correlate.py``) against the plain reference that decides the
benchmark's ``correct`` (``mvsbench/reference/transmvsnet.py``), on the CPU,
on the benchmark's seeded weights, at 64x128, 3 views, ndepths 8/8/8:

* each piece on its own: the LoFTR layer (self, and cross with the
  reference's sums shared by the source views), linear attention (also
  against its quadratic definition), the position encoding, the deformable
  convolution (also against a direct per-tap loop over ``grid_sample``),
  the FMT with its pathway, the view-weight net and the hypotheses;
* the whole forward: stage 1's probability volume held tight, and a depth
  that differs only where the reference's two most probable planes lie
  within 1e-5 of each other (winner-take-all flips there on rounding);
  and every stage's volume held tight against the reference seeded with
  the port's own depths, as the benchmark's check compares them;
* the spans and counters of a forward;
* DMVSNet's three configurations keep their state-dict keys and shapes,
  their seeded weights and their CPU outputs bit for bit (digests of the
  tree before TransMVSNet came in);
* ``init_weights`` leaves no float entry of either architecture
  uninitialised after ``to_empty``;
* ``architecture`` and ``agg_mode`` are refused by name.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.core import sampling
from dmvsnet_tpu_torch.engine import evaluate, profiler
from dmvsnet_tpu_torch.engine.train import Trainer, build_model
from dmvsnet_tpu_torch.models import transmvsnet as port
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.models.mvsnet import MVSNet
from dmvsnet_tpu_torch.ops import deform_conv
from mvsbench import weights
from mvsbench.reference import transmvsnet as ref_mod
from mvsbench.traffic import scenes

BENCH = Path(__file__).resolve().parents[1] / "mvsbench"
SEED = 2_147_484_211
H, W, V = 64, 128, 3
NDEPTHS, RATIOS = (8, 8, 8), (4.0, 1.0, 0.5)
# rtol 1e-5 for the pieces: both sides are fp32 and compute the same
# equations, in another order (batched views, other reductions and matmul
# shapes); what is left is rounding, a few ulp through a handful of layers
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _config(**kw) -> Config:
    return Config(**{**dict(architecture="transmvsnet", agg_mode="pixelwise", ndepths=NDEPTHS,
                            interval_ratio=RATIOS, warp_impl="torch", seed=5, num_view=V,
                            max_h=H, max_w=W), **kw})


@pytest.fixture(scope="module")
def models():
    """The program and the reference on one seed's weights, and one scene of
    ``tank_transmvsnet``'s traffic at the tests' size."""
    model = evaluate.build_model(_config(), torch.device("cpu"))
    sd = weights.generate(model.state_dict(), SEED, "cpu")
    model.load_state_dict(sd)
    ref = ref_mod.build({"ndepths": list(NDEPTHS), "interval_ratio": list(RATIOS)}, "cpu")
    ref.load_state_dict(sd)  # strict: the program's names
    traffic = json.loads((BENCH / "workloads" / "tank_transmvsnet.json").read_text())["traffic"]
    s = scenes.pool(SEED, traffic, V, H, W, 3, 192, "cpu")[0]
    args = (torch.from_numpy(s["imgs"])[None],
            {k: torch.from_numpy(v)[None] for k, v in s["proj_matrices"].items()},
            torch.from_numpy(s["depth_values"])[None])
    return model.eval(), ref.eval(), args


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(7)


# -------------------------------------------------------------- pieces


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_the_loftr_layer_matches_the_reference(models, kind):
    model, ref, _ = models
    layer, want = model.FMT_with_pathway.FMT.layers[1], ref.FMT_with_pathway.FMT.layers[1]
    g = _generator()
    x = torch.randn(4, 96, 32, generator=g)
    with torch.no_grad():
        if kind == "self":
            _close(layer(x, x), want(x, x))
        else:
            # two batch elements of two source views each, one reference each
            source = torch.randn(2, 80, 32, generator=g)
            _close(layer(x, source, 2), want(x, source.repeat_interleave(2, 0)))


def test_linear_attention_matches_the_reference_and_its_definition():
    g = _generator()
    q, k, v = (torch.randn(2, n, 8, 4, generator=g) for n in (50, 70, 70))
    got = port.linear_attention(q, k, v)
    _close(got, ref_mod.LinearAttention()(q, k, v))
    # the quadratic form: m_l = sum_s (phi(q_l) . phi(k_s)) v_s / sum_s (phi(q_l) . phi(k_s))
    fq, fk = F.elu(q) + 1, F.elu(k) + 1
    a = torch.einsum("nlhd,nshd->nhls", fq, fk)
    want = torch.einsum("nhls,nshv->nlhv", a, v) / (a.sum(-1).permute(0, 2, 1)[..., None] + 1e-6)
    _close(got, want)
    # a source row serving two query rows gives what the repeated rows give
    _close(port.linear_attention(q, k[:1], v[:1], 2),
           port.linear_attention(q, k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1)))


def test_the_position_encoding_matches_the_reference(models):
    model, ref, _ = models
    with torch.no_grad():
        got = model.FMT_with_pathway.FMT.pos_encoding(12, 20, "cpu")
        want = ref.FMT_with_pathway.FMT.pos_encoding(torch.zeros(1, 32, 12, 20))
    _close(got, want.flatten(2).transpose(1, 2))


def _direct_dcn(x, om, weight, bias):
    """The DCN by a direct loop over the taps, each sample from
    ``grid_sample`` (bilinear, zeros outside, pixel centres on the grid)."""
    n, c, h, w = x.shape
    rows = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    out = bias[None, :, None, None].expand(n, -1, h, w).clone()
    for ky in range(3):
        for kx in range(3):
            k = 3 * ky + kx
            py = rows + (ky - 1) + om[:, 2 * k]
            px = cols + (kx - 1) + om[:, 2 * k + 1]
            grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], dim=-1)
            sampled = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
            sampled = sampled * torch.sigmoid(om[:, 18 + k])[:, None]
            out += torch.einsum("nchw,oc->nohw", sampled, weight[:, :, ky, kx])
    return out


def test_the_deformable_convolution_matches_a_direct_loop_and_the_reference(models):
    model, ref, _ = models
    dcn, want = model.feature.out2[1], ref.feature.out2[1]
    g = _generator()
    x = torch.randn(2, 32, 12, 16, generator=g)
    with torch.no_grad():
        got = dcn(x)
        # offsets of a few pixels, so that taps leave the image and cross cells
        om = dcn.conv_offset_mask(x) * 8.0
        direct = _direct_dcn(x, om, dcn.weight, dcn.bias)
        _close(deform_conv.deform_conv2d(x, om, dcn.weight, dcn.bias), direct)
        _close(got, want(x))
    assert got.shape == (2, 16, 12, 16)


def test_the_fmt_and_its_pathway_match_the_reference(models):
    model, ref, _ = models
    g = _generator()
    feats = {f"stage{s + 1}": torch.randn(2 * V, c, 8 * 2 ** s, 12 * 2 ** s, generator=g)
             for s, c in enumerate((32, 16, 8))}
    with torch.no_grad():
        got = model.FMT_with_pathway(feats, 2, V)
        views = [{k: f[b * V + i:b * V + i + 1] for k, f in feats.items()}
                 for b in range(2) for i in range(V)]
        want = [ref.FMT_with_pathway(views[b * V:(b + 1) * V]) for b in range(2)]
    for k in feats:
        w = torch.stack([torch.cat([o[k] for o in want[b]]) for b in range(2)])
        _close(got[k], w.permute(0, 1, 3, 4, 2))


def test_the_view_weight_net_matches_the_reference(models):
    model, ref, _ = models
    sim = torch.randn(2, 8, 10, 12, generator=_generator()) * 0.1
    with torch.no_grad():
        _close(model.DepthNet.pixel_wise_net(sim), ref.DepthNet.pixel_wise_net(sim[:, None]))


def test_the_uniform_hypotheses_match_the_reference():
    dv = torch.linspace(1000.0, 8000.0, 192)[None].repeat(2, 1)
    _close(sampling.uniform_samples(dv, 48, 6, 10),
           ref_mod.depth_samples(dv, None, 48, None, (24, 40), (6, 10)), rtol=0, atol=0)
    last = 3000.0 + 500.0 * torch.rand(2, 6, 10, generator=_generator())
    interval = dv[0, 1] - dv[0, 0]
    for size in ((12, 20), (24, 40)):
        _close(sampling.uniform_window_samples(last, 32, interval, (24, 40), *size),
               ref_mod.depth_samples(dv, last, 32, interval, (24, 40), size))


# ---------------------------------------------------------------- whole


def test_the_forward_matches_the_reference(models):
    model, ref, args = models
    with torch.no_grad():
        got, want = model(*args), ref(*args)
    # probabilities lie in [0, 1]; the stage-1 volume is reached without an
    # argmax, so only rounding separates the two
    _close(got["stage1"]["prob_volume"], want["stage1"]["prob_volume"], rtol=0, atol=1e-6)
    for s in ("stage1", "stage2", "stage3"):
        p = want[s]["prob_volume"]
        top2 = p.topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 1e-5
        differ = got[s]["depth"] != want[s]["depth"]
        assert not (differ & ~tie).any(), s
    assert got["depth"].shape == (1, H, W)
    assert torch.equal(got["depth"], got["stage3"]["depth"])


def test_the_reference_seeded_with_the_ports_depths_matches_every_stage(models):
    """The comparison of the benchmark's mode ``infer_cascade``: the
    reference, its later stages seeded with the port's depths (keyword
    ``seeds``), holds every stage's hypotheses and volume to rounding, flips
    or not; seeded with its own depths it gives its own outputs bit for
    bit."""
    model, ref, args = models
    with torch.no_grad():
        got, own = model(*args), ref(*args)
        same = ref(*args, seeds={s: own[s]["depth"] for s in ("stage1", "stage2")})
        want = ref(*args, seeds={s: got[s]["depth"] for s in ("stage1", "stage2")})
    for s in ("stage1", "stage2", "stage3"):
        for k in ("depth", "prob_volume", "depth_values"):
            assert torch.equal(same[s][k], own[s][k]), (s, k)
        _close(got[s]["depth_values"], want[s]["depth_values"])
        _close(got[s]["prob_volume"], want[s]["prob_volume"], rtol=0, atol=1e-6)


def test_a_forward_records_its_spans_and_counters(models, tmp_path):
    model, _, args = models
    port.reset_fmt_stats()
    deform_conv.reset_stats()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(*args)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("mvsnet.")]
    stages = [f"mvsnet.s{k}.{p}" for k in (1, 2, 3)
              for p in ("sample", "main.cost", "main.costreg", "main.head")]
    want = ["mvsnet.forward", "mvsnet.feature", "mvsnet.arf.s1", "mvsnet.arf.s2",
            "mvsnet.arf.s3", "mvsnet.fmt", *stages, *["mvsnet.s1.main.view_weight"] * (V - 1)]
    assert sorted(names) == sorted(want)
    assert not any(n.endswith(".gate") for n in names)
    tokens = (H // 4) * (W // 4)
    # the reference view through 4 self layers; the V - 1 source views as one
    # batch through 4 self and 4 cross layers
    assert port.fmt_stats() == {"self": 8, "cross": 4, "tokens": tokens * (4 + 8 * (V - 1))}
    assert deform_conv.stats() == {
        "calls": 9, "taps": 9 * 3 * V * sum((H >> s) * (W >> s) for s in (2, 1, 0))}


def test_layer_norm_is_counted_at_seven_operations_an_element():
    x = torch.randn(4, 6, 32)
    kinds = profiler.cost_breakdown(lambda t: F.layer_norm(t, (32,)), x)
    assert kinds["flops"]["norm"] == 7 * x.numel()


# ----------------------------------------------- DMVSNet left as it was

# sha256 of the state dict's (name, shape, dtype) list, of the seeded
# init_weights values, of the benchmark's seeded weights (seed 2**31 - 1 +
# 12345) and of one CPU eval forward's depth and confidence at 64x96, 3
# views, 8/8/8 planes, two torch threads, each taken on the tree before
# TransMVSNet came in
DMVSNET = {
    "dmvsnet_dtu": ("5211c17ab3ca1c9c4754a031f3ead20bf48bb10cd7976a1e9f4327a1a5c57aa9",
                    "aa890997e4dd005792614d146b6c5b5d9cd88bb71cb6927ad55215cc0648dbdd",
                    "87430d91520f1934e00d673d1155c5143e555e411fd94f0e2f018d75d9590eac",
                    "3aac1c575485b2cfb3a7de6fde061ecbeb060cbbe893397f07b8db6ee58efb72"),
    "dmvsnet_tank": ("5211c17ab3ca1c9c4754a031f3ead20bf48bb10cd7976a1e9f4327a1a5c57aa9",
                     "aa890997e4dd005792614d146b6c5b5d9cd88bb71cb6927ad55215cc0648dbdd",
                     "87430d91520f1934e00d673d1155c5143e555e411fd94f0e2f018d75d9590eac",
                     "fecad4ac900b51a3b232d150dddc7fa2b0ecdba35daf149f9668c3a6060ae585"),
    "dmvsnet_tank_adaptive": (
        "ba31e3d26ab9349423601b2f8332f8ecff2dbea03a13d4839de054971a82e502",
        "ac4977b559849acbdc6e28cc6885aacc9e191bd1ad5150fda98dc61db2c8dace",
        "80435a5861c320f113bd22ddd28f5c427ced69d993595ff4fcb2e8c430fe8bc3",
        "0c444eaa8669927c2a93568c454d7afa03365368f8c95af8bf651eb91bbec7f3"),
}


def _sha(chunks) -> str:
    return hashlib.sha256(b"".join(chunks)).hexdigest()


@pytest.mark.parametrize("name", sorted(DMVSNET))
def test_dmvsnet_keeps_its_names_weights_and_outputs(name):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = Config(fea_mode="fpn", agg_mode=c["agg_mode"], ndepths=(8, 8, 8),
                 interval_ratio=tuple(c["interval_ratio"]), inverse_depth=c["inverse_depth"],
                 warp_impl="torch", seed=7, num_view=3, max_h=64, max_w=96)
    model = evaluate.build_model(cfg, torch.device("cpu"))
    sd = model.state_dict()
    keys = _sha([json.dumps([[k, list(v.shape), str(v.dtype)] for k, v in sd.items()]).encode()])
    init = _sha(v.detach().contiguous().numpy().tobytes() for v in sd.values())
    seeded = weights.generate(sd, 2147483647 + 12345, "cpu")
    gen = _sha(v.contiguous().numpy().tobytes() for v in seeded.values())
    model.load_state_dict(seeded)
    traffic = json.loads((BENCH / "workloads" / "tank_eval.json").read_text())["traffic"]
    s = scenes.pool(99, traffic, 3, 64, 96, 3, 192, "cpu")[0]
    with torch.no_grad():
        o = model(torch.from_numpy(s["imgs"])[None],
                  {k: torch.from_numpy(v)[None] for k, v in s["proj_matrices"].items()},
                  torch.from_numpy(s["depth_values"])[None])
    out = _sha([o["depth"].numpy().tobytes(), o["photometric_confidence"].numpy().tobytes()])
    assert (keys, init, gen, out) == DMVSNET[name]


@pytest.mark.parametrize("architecture,agg_mode", [("dmvsnet", "variance"),
                                                   ("dmvsnet", "adaptive"),
                                                   ("transmvsnet", "pixelwise")])
def test_init_weights_leaves_nothing_uninitialised(architecture, agg_mode):
    cfg = _config(architecture=architecture, agg_mode=agg_mode)
    with torch.device("meta"):
        model = (port.TransMVSNet(NDEPTHS, RATIOS, warp_impl="torch")
                 if architecture == "transmvsnet" else MVSNet(NDEPTHS, agg_mode=agg_mode))
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.fill_(float("nan"))
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    left = [k for k, v in model.state_dict().items() if v.is_floating_point() and v.isnan().any()]
    assert not left
    built = build_model(cfg, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(built.state_dict().values(),
                                                 model.state_dict().values()))


@pytest.mark.parametrize("fields,refused,error", [
    (dict(architecture="casmvsnet"), "architecture", ValueError),
    (dict(agg_mode="variance"), "agg_mode", ValueError),
    (dict(agg_mode="adaptive"), "agg_mode", ValueError),
    (dict(architecture="dmvsnet", agg_mode="pixelwise"), "agg_mode", ValueError),
    (dict(warp_impl="epipolar"), "warp_impl", ValueError),
    (dict(remat=True), "remat", ValueError),
])
def test_build_refuses_by_name(fields, refused, error):
    with pytest.raises(error, match=refused):
        build_model(_config(**fields), torch.device("cpu"))


def test_the_trainer_refuses_transmvsnet_by_name():
    with pytest.raises(NotImplementedError, match="architecture"):
        Trainer(_config(), device="cpu")


def test_the_cli_takes_the_architecture():
    args = cli.build_parser().parse_args(["--architecture", "transmvsnet", "--test"])
    cfg = cli.config_from_args(args)
    assert (cfg.architecture, cfg.agg_mode) == ("transmvsnet", "pixelwise")
    assert Config().architecture == "dmvsnet"
    with pytest.raises(SystemExit):  # pixelwise is TransMVSNet's alone, never a choice
        cli.build_parser().parse_args(["--agg_mode", "pixelwise"])
