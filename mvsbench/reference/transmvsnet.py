"""The plain PyTorch reference of TransMVSNet at test time, which decides
``correct`` for the configuration ``transmvsnet_tank``.

TransMVSNet: Ding et al., "TransMVSNet: Global Context-aware Multi-view
Stereo Network with Transformers", CVPR 2022 (github.com/megvii-research/
TransMVSNet, ``models/TransMVSNet.py``, ``models/FMT.py``,
``models/module.py``).  No upstream source is in this repository: this
file is written from the paper's equations and those of its parts (LoFTR's
encoder layer with linear attention, Sun et al., CVPR 2021, and
Katharopoulos et al., ICML 2020; SuperGlue's keypoint encoder, Sarlin et
al., CVPR 2020; the modulated deformable convolution DCNv2, Zhu et al.,
CVPR 2019; the CasMVSNet cascade, Gu et al., CVPR 2020), as
``PERF.md`` and the program's ``models/transmvsnet.py`` state them.  It
runs in float32 (the modes switch TF32 off before they build it), one
view at a time, and imports nothing of the program and nothing of JAX.
The state-dict names are the program's, so the benchmark's seeded weights
fill both models alike.

* features, per view: the FPN of ``reference/model.py`` (conv0-conv2,
  inner1, inner2, nearest 2x top-down, width 32) with single-width heads,
  the Adaptive Receptive Field: ``out1`` a 1x1 conv block 32 -> 32 and
  DCN 32 -> 32, BN, ReLU, DCN 32 -> 32, BN, ReLU, DCN 32 -> 32; ``out2`` a
  3x3 conv block 32 -> 32 and DCNs 32 -> 16 -> 16 -> 16 likewise; ``out3``
  the same with 8.  A DCN is y(p) = b + sum_k W_k m_k(p) x(p + p_k +
  dp_k(p)) over the 3x3 taps p_k, with [dp, mask logits] from
  ``conv_offset_mask`` (3x3 with bias, 27 outputs: channel 2k dy_k, 2k + 1
  dx_k, 18 + k the logit of m_k = sigmoid), x sampled bilinearly with zeros
  outside (``model.bilinear_sample``);
* the FMT over the stage-1 features: PE(f) = f + KENC(n), n = ((col, row)
  - (W/2, H/2)) / (0.7 max(W, H)), KENC = Conv1d 2 -> 32, BN1d, ReLU,
  32 -> 64, BN1d, ReLU, 64 -> 128, BN1d, ReLU, 128 -> 32, BN1d, ReLU,
  Conv1d 32 -> 32; eight LoFTR layers (self, cross) x 4, d_model 32, 8
  heads, linear attention with elu + 1; the reference view through the self
  layers (keeping each output), each source view through self, then cross
  against the reference's output of the same depth;
* the pathway, per view: f2 <- smooth_1(up(dimred_1(f1)) + f2), f3 <-
  smooth_2(up(dimred_2(f2)) + f3), up bilinear (half-pixel centres);
* hypotheses: CasMVSNet's ``get_depth_range_samples``: stage 1 uniform over
  the range, later stages ndepth uniform planes over [d - ndepth/2 i,
  d + ndepth/2 i] around the previous depth resized to full resolution,
  then resized to the stage's, i = ratio * (depth_values[0, 1] -
  depth_values[0, 0]);
* per source view i, the pair's correlation through ``model.cost_pass`` at
  V = 2, looked up in ``mvsbench.reference.model`` at each call (so that
  ``mvsbench/counts`` counts each pair as a pass of its own), its two
  groups averaged: S_i; at stage 1 w_i = max_D sigmoid(P(S_i)), P = 1x1x1
  conv blocks 1 -> 16 -> 8 and a 1x1x1 conv 8 -> 1 with bias; at later
  stages the previous weights upsampled by nearest 2x; C = sum_i w_i S_i /
  (sum_i w_i + 1e-5);
* a 3-D U-Net a stage (CasMVSNet's ``CostRegNet``, 1 channel in, 1 out),
  softmax over D, the depth at the argmax (winner-take-all) and its
  probability as the confidence.

Departures from upstream:

* upstream's top-down path and FPN are taken here as the repository's own
  (nearest 2x upsampling, the DMVSNet encoder), as the program takes them;
* upstream's feature-net blocks, ``conv_offset_mask`` and KENC start from
  their own initialisations (DCN offsets zero, KENC's last bias zero); the
  benchmark's weights are seeded for every entry, offsets included;
* upstream starts its sum of view weights at 1e-5 and adds each weight to
  it; here the weights are summed and 1e-5 added after (the same quantity,
  another rounding order);
* upstream resizes the later stages' hypotheses with trilinear
  interpolation at the same plane count, which is this bilinear resize;
* upstream's DCN is DCNv2's CUDA extension (an im2col column buffer and one
  GEMM); here each tap is sampled and summed in turn.

Sizes taken from memory of the upstream code, not from the paper
(``configs/transmvsnet_tank.json`` lists them under ``assumed``): the ARF
layer list above, KENC's widths (32, 64, 128), PixelwiseNet's widths
(16, 8), and the recipe's ``ndepths`` (48, 32, 8) and interval ratios
(4, 1, 0.5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvsbench.reference import model


# ------------------------------------------------------------- features


class DCN(nn.Module):
    """A 3x3 modulated deformable convolution, stride 1, padding 1, with
    bias; DCNv2's parameter layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        om = self.conv_offset_mask(x)
        img = x.permute(0, 2, 3, 1).contiguous()
        rows = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
        cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
        out = self.bias[None, :, None, None]
        for k in range(9):
            ky, kx = divmod(k, 3)
            y = rows + (ky - 1) + om[:, 2 * k]
            xx = cols + (kx - 1) + om[:, 2 * k + 1]
            sampled = model.bilinear_sample(img, xx, y) * torch.sigmoid(om[:, 18 + k])[..., None]
            out = out + torch.einsum("bhwc,oc->bohw", sampled, self.weight[:, :, ky, kx])
        return out


def arf_head(cin: int, cout: int, kernel: int) -> nn.Sequential:
    return nn.Sequential(model.Block(cin, cin, kernel),
                         DCN(cin, cout), model.BatchNorm2d(cout), nn.ReLU(),
                         DCN(cout, cout), model.BatchNorm2d(cout), nn.ReLU(),
                         DCN(cout, cout))


class FeatureNet(nn.Module):
    def __init__(self, c: int = 8):
        super().__init__()
        self.conv0 = nn.Sequential(model.Block(3, c, 3, 1), model.Block(c, c, 3, 1))
        self.conv1 = nn.Sequential(model.Block(c, c * 2, 5, 2), model.Block(c * 2, c * 2, 3, 1),
                                   model.Block(c * 2, c * 2, 3, 1))
        self.conv2 = nn.Sequential(model.Block(c * 2, c * 4, 5, 2),
                                   model.Block(c * 4, c * 4, 3, 1),
                                   model.Block(c * 4, c * 4, 3, 1))
        self.out1 = arf_head(c * 4, c * 4, 1)
        self.inner1 = model.plain_conv(c * 2, c * 4, 1, bias=True)
        self.out2 = arf_head(c * 4, c * 2, 3)
        self.inner2 = model.plain_conv(c, c * 4, 1, bias=True)
        self.out3 = arf_head(c * 4, c, 3)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        intra = self.conv2(conv1)
        out1 = self.out1(intra)
        intra = model.upsample_nearest_2x(intra) + self.inner1(conv1)
        out2 = self.out2(intra)
        intra = model.upsample_nearest_2x(intra) + self.inner2(conv0)
        return {"stage1": out1, "stage2": out2, "stage3": self.out3(intra)}


# ------------------------------------------------------------------- FMT


class LinearAttention(nn.Module):
    def forward(self, queries, keys, values):
        q = F.elu(queries) + 1
        k = F.elu(keys) + 1
        length = values.size(1)
        values = values / length
        kv = torch.einsum("nshd,nshv->nhdv", k, values)
        z = 1 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
        return torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * length


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.dim = d_model // nhead
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.attention = LinearAttention()
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(d_model * 2, d_model * 2, bias=False), nn.ReLU(),
                                 nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, source):
        bs = x.size(0)
        query = self.q_proj(x).view(bs, -1, self.nhead, self.dim)
        key = self.k_proj(source).view(bs, -1, self.nhead, self.dim)
        value = self.v_proj(source).view(bs, -1, self.nhead, self.dim)
        message = self.attention(query, key, value)
        message = self.norm1(self.merge(message.reshape(bs, -1, self.nhead * self.dim)))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=2)))
        return x + message


class KeypointEncoder(nn.Module):
    def __init__(self, d_model: int = 32, widths=(32, 64, 128)):
        super().__init__()
        chans = [2, *widths, d_model, d_model]
        layers = []
        for i in range(1, len(chans)):
            layers.append(nn.Conv1d(chans[i - 1], chans[i], 1, bias=True))
            if i < len(chans) - 1:
                layers += [nn.BatchNorm1d(chans[i]), nn.ReLU()]
        self.encoder = nn.Sequential(*layers)


class PositionEncoding(nn.Module):
    def __init__(self, d_model: int = 32):
        super().__init__()
        self.kenc = KeypointEncoder(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> x + KENC(n)."""
        n, c, h, w = x.shape
        rows = torch.arange(h, dtype=torch.float32, device=x.device)[:, None].expand(h, w)
        cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, :].expand(h, w)
        xy = torch.stack([cols.reshape(-1), rows.reshape(-1)])
        centre = torch.tensor([w / 2, h / 2], dtype=torch.float32, device=x.device)
        norm = (xy - centre[:, None]) / (0.7 * max(w, h))
        return x + self.kenc.encoder(norm[None]).view(1, c, h, w)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


class FMT(nn.Module):
    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.layer_names = ("self", "cross") * 4
        self.layers = nn.ModuleList([LoFTREncoderLayer(d_model, nhead)
                                     for _ in self.layer_names])
        self.pos_encoding = PositionEncoding(d_model)

    def reference_view(self, f: torch.Tensor) -> list[torch.Tensor]:
        """The reference view's outputs of the four self layers, as tokens."""
        ref, outs = _tokens(self.pos_encoding(f)), []
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                ref = layer(ref, ref)
                outs.append(ref)
        return outs

    def source_view(self, refs: list[torch.Tensor], f: torch.Tensor) -> torch.Tensor:
        src = _tokens(self.pos_encoding(f))
        for i, (layer, name) in enumerate(zip(self.layers, self.layer_names)):
            src = layer(src, src) if name == "self" else layer(src, refs[i // 2])
        return src


class FMTWithPathway(nn.Module):
    def __init__(self, c: int = 8):
        super().__init__()
        self.FMT = FMT(c * 4, 8)
        self.dim_reduction_1 = nn.Conv2d(c * 4, c * 2, 1, bias=False)
        self.dim_reduction_2 = nn.Conv2d(c * 2, c, 1, bias=False)
        self.smooth_1 = nn.Conv2d(c * 2, c * 2, 3, padding=1, bias=False)
        self.smooth_2 = nn.Conv2d(c, c, 3, padding=1, bias=False)

    def forward(self, views: list[dict[str, torch.Tensor]]) -> list[dict[str, torch.Tensor]]:
        out, refs = [], None
        for i, f in enumerate(views):
            _, _, h, w = f["stage1"].shape
            if i == 0:
                refs = self.FMT.reference_view(f["stage1"])
                t = refs[-1]
            else:
                t = self.FMT.source_view(refs, f["stage1"])
            f1 = t.transpose(1, 2).reshape(f["stage1"].shape)
            f2 = self.smooth_1(_up(self.dim_reduction_1(f1), f["stage2"]) + f["stage2"])
            f3 = self.smooth_2(_up(self.dim_reduction_2(f2), f["stage3"]) + f["stage3"])
            out.append({"stage1": f1, "stage2": f2, "stage3": f3})
        return out


def _up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=like.shape[-2:], mode="bilinear", align_corners=False)


# ---------------------------------------------------- cost and heads


class PixelwiseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = model.Block(1, 16, 1, dims=3)
        self.conv1 = model.Block(16, 8, 1, dims=3)
        self.conv2 = model.plain_conv(8, 1, 1, dims=3, bias=True)

    def forward(self, sim: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) -> (B, H, W)."""
        x = self.conv2(self.conv1(self.conv0(sim))).squeeze(1)
        return torch.max(torch.sigmoid(x), dim=1)[0]


class CostRegNet(nn.Module):
    """CasMVSNet's 3-D U-Net, one channel in and one out."""

    def __init__(self, b: int = 8):
        super().__init__()
        self.conv0 = model.Block(1, b, dims=3)
        self.conv1 = model.Block(b, b * 2, stride=2, dims=3)
        self.conv2 = model.Block(b * 2, b * 2, dims=3)
        self.conv3 = model.Block(b * 2, b * 4, stride=2, dims=3)
        self.conv4 = model.Block(b * 4, b * 4, dims=3)
        self.conv5 = model.Block(b * 4, b * 8, stride=2, dims=3)
        self.conv6 = model.Block(b * 8, b * 8, dims=3)
        self.conv7 = model.Block(b * 8, b * 4, dims=3, transposed=True)
        self.conv9 = model.Block(b * 4, b * 2, dims=3, transposed=True)
        self.conv11 = model.Block(b * 2, b, dims=3, transposed=True)
        self.prob = model.plain_conv(b, 1, 3, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        y = self.conv6(self.conv5(conv4))
        y = conv4 + self.conv7(y)
        y = conv2 + self.conv9(y)
        y = conv0 + self.conv11(y)
        return self.prob(y)


def depth_samples(depth_values, last_depth, ndepth: int, interval, full, size):
    """CasMVSNet's hypotheses, (B, ndepth, h, w) at ``size``."""
    arange = torch.arange(ndepth, dtype=torch.float32, device=depth_values.device)
    if last_depth is None:
        dmin, dmax = depth_values[:, 0], depth_values[:, -1]
        flat = dmin[:, None] + arange[None, :] * ((dmax - dmin) / (ndepth - 1))[:, None]
        return flat[:, :, None, None].expand(flat.shape[0], ndepth, *size)
    d = F.interpolate(last_depth[:, None], size=full, mode="bilinear",
                      align_corners=False)[:, 0]
    dmin = d - ndepth / 2 * interval
    dmax = d + ndepth / 2 * interval
    samples = dmin[:, None] + arange[None, :, None, None] * ((dmax - dmin) / (ndepth - 1))[:, None]
    return F.interpolate(samples, size=size, mode="bilinear", align_corners=False)


class TransMVSNet(nn.Module):
    def __init__(self, ndepths=(48, 32, 8), interval_ratio=(4.0, 1.0, 0.5)):
        super().__init__()
        self.ndepths = tuple(ndepths)
        self.interval_ratio = tuple(interval_ratio)
        self.feature = FeatureNet(8)
        self.FMT_with_pathway = FMTWithPathway(8)
        self.cost_regularization = nn.ModuleList([CostRegNet(8) for _ in self.ndepths])
        self.DepthNet = nn.ModuleDict({"pixel_wise_net": PixelwiseNet()})

    def forward(self, imgs, proj_matrices, depth_values, seeds=None) -> dict:
        """``seeds`` (optional, ``{"stage{k}": (B, H_k, W_k) depth}``): stage
        k + 1's hypotheses are placed around the given stage-k depth in place
        of this model's own (mode ``infer_cascade`` passes the program's, so
        that each stage is compared on the hypotheses the program took)."""
        num_stage = len(self.ndepths)
        b, v, h, w, _ = imgs.shape
        depth_values = depth_values.float()
        interval = depth_values[0, 1] - depth_values[0, 0]
        views = [self.feature(imgs[:, i].float().permute(0, 3, 1, 2).contiguous())
                 for i in range(v)]
        views = self.FMT_with_pathway(views)
        outputs: dict = {}
        depth = view_weights = None
        for s in range(num_stage):
            stage = f"stage{s + 1}"
            scale = 2 ** (num_stage - s - 1)
            size = (h // scale, w // scale)
            last = depth if seeds is None or s == 0 else seeds[f"stage{s}"].float()
            samples = depth_samples(depth_values, last, self.ndepths[s],
                                    self.interval_ratio[s] * interval, (h, w), size)
            feats = torch.stack([f[stage].permute(0, 2, 3, 1) for f in views], 1).contiguous()
            rel = model.relative_projections(proj_matrices[stage])
            if view_weights is not None:
                view_weights = F.interpolate(view_weights, scale_factor=2, mode="nearest")
            weighted, weights = None, []
            for i in range(1, v):
                corr = model.cost_pass(feats[:, [0, i]], rel[:, i - 1:i].contiguous(),
                                       samples.contiguous())
                sim = corr.mean(-1)
                if view_weights is None:
                    wi = self.DepthNet.pixel_wise_net(sim[:, None])
                else:
                    wi = view_weights[:, i - 1]
                weights.append(wi)
                term = sim * wi[:, None]
                weighted = term if weighted is None else weighted + term
            total = weights[0]
            for wi in weights[1:]:
                total = total + wi
            similarity = weighted / (total + 1e-5)[:, None]
            if view_weights is None:
                view_weights = torch.stack(weights, 1)
            prob = torch.softmax(self.cost_regularization[s](similarity[:, None]).squeeze(1),
                                 dim=1)
            conf, idx = torch.max(prob, dim=1, keepdim=True)
            depth = torch.gather(samples, 1, idx).squeeze(1)
            out = {"depth": depth, "prob_volume": prob, "depth_values": samples,
                   "photometric_confidence": conf.squeeze(1)}
            outputs[stage] = out
            outputs.update(out)
        return outputs


def build(config: dict, device) -> TransMVSNet:
    """The reference of a configuration file's dict, uninitialised on
    ``device`` (the benchmark loads its weights)."""
    with torch.device("meta"):
        net = TransMVSNet(config["ndepths"], config["interval_ratio"])
    return net.to_empty(device=device)
