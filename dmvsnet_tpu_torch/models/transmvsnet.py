"""TransMVSNet (Ding et al., "TransMVSNet: Global Context-aware Multi-view
Stereo Network with Transformers", CVPR 2022; github.com/megvii-research/
TransMVSNet), at test time, beside DMVSNet (``models/mvsnet``).  Written
from the paper's equations and its parts' published work; no upstream
source is in this repository, and the JAX package has no counterpart.

Layouts as ``MVSNet``'s: imgs (B, V, H, W, 3) with view 0 the reference,
proj_matrices {"stage1".."stage3": (B, V, 2, 4, 4)}, depth_values (B, D0).
``forward`` returns ``depth`` and ``photometric_confidence`` (the last
stage's) and ``stage{k}`` -> {``depth``, ``prob_volume``,
``depth_values``, ``photometric_confidence``}.  Three stages at 1/4, 1/2
and 1/1 resolution, one cost pass each:

* features (``feature``, ``ARFFeatureNet``): the port's FPN encoder and
  top-down path (``models/feature_net.FPN``) with single-width heads that
  end in modulated deformable convolutions, the Adaptive Receptive Field
  (``ops/deform_conv``): stage widths 32 / 16 / 8;
* the Feature Matching Transformer over the stage-1 features
  (``FMT_with_pathway.FMT``; LoFTR's encoder layer with linear attention,
  Sun et al., CVPR 2021; Katharopoulos et al., ICML 2020): ``d_model`` 32,
  8 heads of 4, layers (self, cross) x 4 with weights of their own, after a
  position encoding PE(f) = f + KENC(n) (SuperGlue's keypoint encoder,
  Sarlin et al., CVPR 2020) of the normalised pixel grid n.  The reference
  view runs the four self layers, r_{j+1} = L_2j(r_j, r_j), and keeps r_4;
  each source view runs s = L_2j(s, s), then s = L_2j+1(s, r_{j+1}).  All
  source views of a batch run as one batch per layer; a cross layer sums
  the reference's keys and values once per batch element;
* the pathway (``FMT_with_pathway``), per view: f2 <- smooth_1(up(dimred_1
  (f1)) + f2), f3 <- smooth_2(up(dimred_2(f2)) + f3), up bilinear 2x;
* hypotheses: CasMVSNet's uniform planes (``core/sampling.uniform_samples``
  and ``uniform_window_samples``), interval_k = ratio_k * (depth_values[0,
  1] - depth_values[0, 0]);
* the cost pass (``ops/warp_correlate.aggregate_cost_volume_pixelwise``):
  per source view i kernel 1 on the (reference, source i) pair, whose two
  group correlations averaged are the one-group similarity S_i; at stage 1
  the view weight w_i = max_D sigmoid(P(S_i)) (``DepthNet.pixel_wise_net``,
  ``PixelwiseNet``), at later stages the previous stage's weights upsampled
  by nearest 2x; C = sum_i w_i S_i / (sum_i w_i + 1e-5);
* a single-branch 3-D U-Net a stage (``cost_regularization``,
  ``models/cost_reg.CostRegNetPart`` with 1 input and 1 output channel);
* the head: p = softmax over D; depth = the hypothesis at argmax_D p;
  photometric_confidence = max_D p.

Dtypes as ``MVSNet``'s: ``feature_dtype`` (None: ``dtype``) is the feature
net's, ``dtype`` the FMT's, the pathway's and the view-weight net's,
``costreg_dtype`` (None: ``dtype``) the U-Nets'; the cost passes and the
heads are fp32, parameters and statistics fp32.  Inference only: the
port's trainer refuses this architecture.

Spans (``utils/trace``): ``mvsnet.forward``; ``mvsnet.feature`` holding
``mvsnet.arf.s{k}`` around each ARF head; ``mvsnet.fmt`` (position
encoding, layers, pathway); per stage ``mvsnet.s{k}.sample``,
``mvsnet.s{k}.main.cost`` (holding, at stage 1, one
``mvsnet.s1.main.view_weight`` per source view), ``mvsnet.s{k}.main.costreg``
and ``mvsnet.s{k}.main.head``.  ``fmt_stats()`` counts the FMT's layer
calls by kind and the query tokens they took; ``ops/deform_conv.stats()``
the deformable convolutions.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmvsnet_tpu_torch.core import sampling
from dmvsnet_tpu_torch.models.blocks import BatchNorm2d, ConvBlock, PlainConv
from dmvsnet_tpu_torch.models.cost_reg import CostRegNetPart
from dmvsnet_tpu_torch.models.feature_net import FPN
from dmvsnet_tpu_torch.models.mvsnet import check_shapes
from dmvsnet_tpu_torch.ops import warp_correlate
from dmvsnet_tpu_torch.ops.deform_conv import DeformConv2d
from dmvsnet_tpu_torch.utils.trace import span

_FMT_STATS = {"self": 0, "cross": 0, "tokens": 0}
_FMT_STATS_LOCK = threading.Lock()


def fmt_stats() -> dict[str, int]:
    """The FMT's layer calls since the last reset: ``self`` and ``cross``
    (one per batched call), and ``tokens``, the query tokens they took."""
    with _FMT_STATS_LOCK:
        return dict(_FMT_STATS)


def reset_fmt_stats() -> None:
    with _FMT_STATS_LOCK:
        for k in _FMT_STATS:
            _FMT_STATS[k] = 0


# ------------------------------------------------------------ features


class _ARFHead(nn.Sequential):
    """An ARF head: a conv block, then DCN, BN, ReLU, DCN, BN, ReLU, DCN,
    inside the span ``mvsnet.arf.s{stage}``."""

    def __init__(self, stage: int, cin: int, cout: int, kernel: int, dtype: torch.dtype):
        super().__init__(ConvBlock(cin, cin, kernel, dtype=dtype),
                         DeformConv2d(cin, cout, dtype), BatchNorm2d(cout), nn.ReLU(inplace=True),
                         DeformConv2d(cout, cout, dtype), BatchNorm2d(cout), nn.ReLU(inplace=True),
                         DeformConv2d(cout, cout, dtype))
        self.span = f"mvsnet.arf.s{stage}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(self.span):
            return super().forward(x)


class ARFFeatureNet(FPN):
    """The FPN with TransMVSNet's Adaptive Receptive Field heads: ``out1``
    a 1x1 conv block 32 -> 32 and DCNs 32 -> 32 -> 32 -> 32, ``out2`` a 3x3
    conv block 32 -> 32 and DCNs 32 -> 16 -> 16 -> 16, ``out3`` the same with
    8 for 16 (base 8)."""

    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32):
        c = base_channels
        super().__init__((_ARFHead(1, c * 4, c * 4, 1, dtype), _ARFHead(2, c * 4, c * 2, 3, dtype),
                          _ARFHead(3, c * 4, c, 3, dtype)), c, dtype)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, 3, H, W) -> {stage1..3}, each (N, C, h, w)."""
        return {f"stage{s + 1}": out for s, out in enumerate(self._unfolded(x))}


# ------------------------------------------------------------------- FMT


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` (no bias) in ``x``'s dtype (fp32 parameters)."""
    return F.linear(x, layer.weight.to(x.dtype))


def _norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Layer norm computed in fp32, returned in ``x``'s dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


def _phi(t: torch.Tensor) -> torch.Tensor:
    return F.elu(t) + 1


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     repeat: int = 1) -> torch.Tensor:
    """Linear attention with phi = elu + 1, per head: q (N, L, h, d); k, v
    (N / repeat, S, h, d), source row j serving query rows j * repeat ..
    (j + 1) * repeat - 1 (its sums are formed once).  KV = sum_s
    phi(k_s)^T (v_s / S), z_l = 1 / (phi(q_l) . sum_s phi(k_s) + 1e-6),
    returns m_l = S z_l phi(q_l) KV, (N, L, h, d)."""
    length = k.shape[1]
    k = _phi(k)
    kv = torch.einsum("nshd,nshv->nhdv", k, v / length)
    ksum = k.sum(dim=1)
    if repeat > 1:
        kv, ksum = kv.repeat_interleave(repeat, 0), ksum.repeat_interleave(repeat, 0)
    q = _phi(q)
    z = 1 / (torch.einsum("nlhd,nhd->nlh", q, ksum) + 1e-6)
    return torch.einsum("nlhd,nhdv->nlhv", q, kv) * z[..., None] * length


class LoFTRLayer(nn.Module):
    """LoFTR's encoder layer with linear attention:
    q = x Wq, k = s Wk, v = s Wv split into heads, phi = elu + 1; per head
    KV = sum_s phi(k_s)^T (v_s / S), z_l = 1 / (phi(q_l) . sum_s phi(k_s)
    + 1e-6), m_l = S z_l phi(q_l) KV; m = LN1(concat_heads(m) Wmerge);
    out = x + LN2(MLP([x ; m])), MLP = Linear 2C -> 2C, ReLU, Linear
    2C -> C, all bias-free."""

    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        # a Sequential for the state dict's names (mlp.0, mlp.2); forward
        # applies its two layers itself, in the compute dtype
        self.mlp = nn.Sequential(nn.Linear(d_model * 2, d_model * 2, bias=False),
                                 nn.ReLU(inplace=True),
                                 nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x: torch.Tensor, source: torch.Tensor, repeat: int = 1) -> torch.Tensor:
        """x: (N, L, C) queries; source: (N / repeat, S, C), row j the source
        of query rows j * repeat .. (j + 1) * repeat - 1."""
        n, length, c = x.shape
        h = self.nhead
        with _FMT_STATS_LOCK:
            _FMT_STATS["self" if source is x else "cross"] += 1
            _FMT_STATS["tokens"] += n * length
        m = linear_attention(_linear(x, self.q_proj).unflatten(-1, (h, c // h)),
                             _linear(source, self.k_proj).unflatten(-1, (h, c // h)),
                             _linear(source, self.v_proj).unflatten(-1, (h, c // h)), repeat)
        m = _norm(_linear(m.reshape(n, length, c), self.merge), self.norm1)
        m = torch.relu(_linear(torch.cat([x, m], dim=2), self.mlp[0]))
        return x + _norm(_linear(m, self.mlp[2]), self.norm2)


class KeypointEncoder(nn.Module):
    """SuperGlue's keypoint encoder: Conv1d 2 -> 32, BN1d, ReLU, 32 -> 64,
    BN1d, ReLU, 64 -> 128, BN1d, ReLU, 128 -> C, BN1d, ReLU, then Conv1d
    C -> C, every Conv1d with a bias."""

    def __init__(self, d_model: int = 32, widths: Sequence[int] = (32, 64, 128)):
        super().__init__()
        chans = [2, *widths, d_model, d_model]
        layers: list[nn.Module] = []
        for i in range(1, len(chans)):
            layers.append(nn.Conv1d(chans[i - 1], chans[i], 1))
            if i < len(chans) - 1:
                layers += [nn.BatchNorm1d(chans[i]), nn.ReLU()]
        self.encoder = nn.Sequential(*layers)


class PositionEncoding(nn.Module):
    """KENC(n) of the pixel grid, xy = (col, row), n = (xy - (W/2, H/2)) /
    (0.7 max(W, H)), as (1, H*W, C) tokens in row-major order, fp32."""

    def __init__(self, d_model: int = 32):
        super().__init__()
        self.kenc = KeypointEncoder(d_model)

    def forward(self, height: int, width: int, device) -> torch.Tensor:
        ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                                torch.arange(width, dtype=torch.float32, device=device),
                                indexing="ij")
        centre = torch.tensor([width / 2, height / 2], dtype=torch.float32, device=device)
        grid = (torch.stack([xs, ys]).reshape(2, -1) - centre[:, None]) / (
            0.7 * max(width, height))
        return self.kenc.encoder(grid[None]).transpose(1, 2)


class FMT(nn.Module):
    """The Feature Matching Transformer: layers (self, cross) x 4 after the
    position encoding."""

    layer_names = ("self", "cross") * 4

    def __init__(self, d_model: int = 32, nhead: int = 8):
        super().__init__()
        self.layers = nn.ModuleList([LoFTRLayer(d_model, nhead) for _ in self.layer_names])
        self.pos_encoding = PositionEncoding(d_model)

    def forward(self, tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """(B, V, L, C) tokens of the views, view 0 the reference, L =
        height * width row-major -> the same after the FMT."""
        b, v, length, c = tokens.shape
        tokens = tokens + self.pos_encoding(height, width, tokens.device).to(tokens.dtype)
        ref = tokens[:, 0]
        refs = []
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                ref = layer(ref, ref)
                refs.append(ref)
        src = tokens[:, 1:].reshape(b * (v - 1), length, c)
        for i, (layer, name) in enumerate(zip(self.layers, self.layer_names)):
            src = layer(src, src) if name == "self" else layer(src, refs[i // 2], v - 1)
        return torch.cat([ref[:, None], src.view(b, v - 1, length, c)], dim=1)


class FMTWithPathway(nn.Module):
    """The FMT over the stage-1 features, then the pathway down to stages
    2 and 3: f2 <- smooth_1(up(dimred_1(f1)) + f2), f3 <- smooth_2(up(
    dimred_2(f2)) + f3), up bilinear to the finer size (half-pixel
    centres); dimred 1x1 and smooth 3x3 convolutions without bias."""

    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels
        self.dtype = dtype
        self.FMT = FMT(c * 4, 8)
        self.dim_reduction_1 = PlainConv(c * 4, c * 2, kernel=1, dtype=dtype)
        self.dim_reduction_2 = PlainConv(c * 2, c, kernel=1, dtype=dtype)
        self.smooth_1 = PlainConv(c * 2, c * 2, kernel=3, dtype=dtype)
        self.smooth_2 = PlainConv(c, c, kernel=3, dtype=dtype)

    def forward(self, feats: dict[str, torch.Tensor], b: int, v: int) -> dict[str, torch.Tensor]:
        """{stage1..3: (B*V, C, h, w)} -> {stage1..3: (B, V, h, w, C)}
        channels-last, in ``dtype``."""
        f1 = feats["stage1"].to(self.dtype)
        n, c, h, w = f1.shape
        tokens = f1.permute(0, 2, 3, 1).reshape(b, v, h * w, c)
        f1 = self.FMT(tokens, h, w).reshape(n, h, w, c).permute(0, 3, 1, 2)
        f2 = self.smooth_1(_upsample_add(self.dim_reduction_1(f1), feats["stage2"].to(self.dtype)))
        f3 = self.smooth_2(_upsample_add(self.dim_reduction_2(f2), feats["stage3"].to(self.dtype)))
        return {f"stage{s + 1}": f.permute(0, 2, 3, 1).reshape(b, v, *f.shape[2:], f.shape[1])
                for s, f in enumerate((f1, f2, f3))}


def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=y.shape[-2:], mode="bilinear", align_corners=False) + y


# ------------------------------------------------------ view weights


class PixelwiseNet(nn.Module):
    """The pixel-wise view-weight net: 1x1x1 conv blocks 1 -> 16 -> 8 (batch
    norm, ReLU), a 1x1x1 conv 8 -> 1 with bias, sigmoid, max over D:
    (B, D, H, W) similarity -> (B, H, W) weight, fp32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBlock(1, 16, kernel=1, dims=3, dtype=dtype)
        self.conv1 = ConvBlock(16, 8, kernel=1, dims=3, dtype=dtype)
        self.conv2 = PlainConv(8, 1, kernel=1, dims=3, use_bias=True, dtype=dtype)

    def forward(self, sim: torch.Tensor) -> torch.Tensor:
        logits = self.conv2(self.conv1(self.conv0(sim[:, None].to(self.dtype))))[:, 0]
        return torch.sigmoid(logits.float()).amax(dim=1)


# --------------------------------------------------------------- model


class TransMVSNet(nn.Module):
    def __init__(
        self,
        ndepths: Sequence[int] = (48, 32, 8),
        depth_interval_ratio: Sequence[float] = (4.0, 1.0, 0.5),
        warp_impl: str = "cuda",
        dtype: torch.dtype = torch.float32,
        feature_dtype: torch.dtype | None = None,
        costreg_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if warp_impl not in ("cuda", "torch"):
            raise ValueError(f"TransMVSNet's warp_impl must be 'cuda' or 'torch', got "
                             f"{warp_impl!r}")
        self.ndepths = tuple(ndepths)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.warp_impl = warp_impl
        self.compute_dtype = dtype
        self.costreg_dtype = dtype if costreg_dtype is None else costreg_dtype
        self.feature = ARFFeatureNet(dtype=dtype if feature_dtype is None else feature_dtype)
        self.FMT_with_pathway = FMTWithPathway(dtype=dtype)
        self.cost_regularization = nn.ModuleList(
            [CostRegNetPart(1, 8, self.costreg_dtype, out_channels=1) for _ in self.ndepths])
        self.DepthNet = nn.ModuleDict({"pixel_wise_net": PixelwiseNet(dtype)})

    def forward(self, imgs: torch.Tensor, proj_matrices: dict[str, torch.Tensor],
                depth_values: torch.Tensor) -> dict[str, Any]:
        with span("mvsnet.forward"):
            return self._forward(imgs, proj_matrices, depth_values)

    def _forward(self, imgs, proj_matrices, depth_values) -> dict[str, Any]:
        num_stage = len(self.ndepths)
        b, v, h, w, _ = imgs.shape
        check_shapes(h, w, self.ndepths)
        depth_values = depth_values.float()
        interval = depth_values[0, 1] - depth_values[0, 0]
        x = imgs.float().reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2)
        with span("mvsnet.feature"):
            feats = self.feature(x.contiguous())
        with span("mvsnet.fmt"):
            feats = self.FMT_with_pathway(feats, b, v)

        outputs: dict[str, Any] = {}
        depth = weights = None
        for s in range(num_stage):
            stage, name = f"stage{s + 1}", f"mvsnet.s{s + 1}"
            scale = 2 ** (num_stage - s - 1)
            sh, sw = h // scale, w // scale
            with span(name + ".sample"):
                if s == 0:
                    samples = sampling.uniform_samples(depth_values, self.ndepths[0], sh, sw)
                else:
                    samples = sampling.uniform_window_samples(
                        depth.detach(), self.ndepths[s], self.depth_interval_ratio[s] * interval,
                        (h, w), sh, sw)
            with span(name + ".main.cost"):
                if weights is None:
                    def weight_fn(i, sim, name=name):
                        with span(name + ".main.view_weight"):
                            return self.DepthNet.pixel_wise_net(sim)
                else:
                    weights = F.interpolate(weights, scale_factor=2, mode="nearest")

                    def weight_fn(i, sim, weights=weights):
                        return weights[:, i]
                cost, weights = warp_correlate.aggregate_cost_volume_pixelwise(
                    feats[stage], proj_matrices[stage], samples, weight_fn, self.warp_impl)
            with span(name + ".main.costreg"):
                reg = self.cost_regularization[s](cost.to(self.costreg_dtype)[:, None])
            with span(name + ".main.head"):
                prob = torch.softmax(reg[:, 0].float(), dim=1)
                conf, idx = prob.max(dim=1, keepdim=True)
                depth = torch.gather(samples, 1, idx)[:, 0]
            stage_out = {"depth": depth, "prob_volume": prob, "depth_values": samples,
                         "photometric_confidence": conf[:, 0]}
            outputs[stage] = stage_out
            outputs.update(stage_out)
        return outputs
