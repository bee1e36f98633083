"""The plain PyTorch reference of DMVSNet that decides ``correct``.

A frozen copy of the fp32 plain path of ``dmvsnet_tpu_torch`` at commit
1e68102 (``models/{blocks,feature_net,cost_reg,depth_net,mvsnet}.py``,
``core/{sampling,geometry}.py``, ``ops/warp.py``), with everything that path
does not run taken out: no CUDA kernel, no folded plan, no mesh, no bf16
casts, no remat, no epipolar or adaptive routing.  It imports nothing of the
program; the state-dict names are the program's (the upstream layout), so
the benchmark loads the same tensors into both.

The operations are the program's, in the program's order, so that
``mvsbench/counts`` counts this model exactly as the program's
``engine/profiler.cost_analysis`` counts the program.  The cost pass is
``cost_pass`` below, which ``mvsbench/counts`` replaces while it counts.

Layouts: imgs (B, V, H, W, 3), view 0 the reference; proj_matrices
{"stage1".."stage3": (B, V, 2, 4, 4)}; depth_values (B, D0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------- blocks


class _BiasedBatchNorm:
    """Batch norm whose train-mode running variance takes the biased batch
    variance: ``var <- (1 - m) var + m * biased variance``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        m = self.momentum
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1.0 - m) / n).add_(var, alpha=(n - 1) / n)
            self.num_batches_tracked += 1
        return y


class BatchNorm2d(_BiasedBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BiasedBatchNorm, nn.BatchNorm3d):
    pass


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


class Block(nn.Module):
    """conv (k//2 padding; transposed: stride 2, output 2x), batch norm
    (eps 1e-5, momentum 0.1), ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dims: int = 2, transposed: bool = False):
        super().__init__()
        if transposed:
            self.conv = _DECONV[dims](cin, cout, kernel, stride=2, padding=kernel // 2,
                                      output_padding=1, bias=False)
        else:
            self.conv = _CONV[dims](cin, cout, kernel, stride=stride, padding=kernel // 2,
                                    bias=False)
        self.bn = _BN[dims](cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def plain_conv(cin: int, cout: int, kernel: int = 1, dims: int = 2,
               bias: bool = False) -> nn.Module:
    return _CONV[dims](cin, cout, kernel, padding=kernel // 2, bias=bias)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


# ----------------------------------------------------------- feature net


class FeatureNet(nn.Module):
    """FPN: stage1 32(+32) channels at 1/4, stage2 16(+16) at 1/2, stage3
    8(+8) at full resolution for base 8; the second half of each head is
    the refine pass's "_c" feature."""

    def __init__(self, c: int = 8):
        super().__init__()
        self.conv0 = nn.Sequential(Block(3, c, 3, 1), Block(c, c, 3, 1))
        self.conv1 = nn.Sequential(Block(c, c * 2, 5, 2), Block(c * 2, c * 2, 3, 1),
                                   Block(c * 2, c * 2, 3, 1))
        self.conv2 = nn.Sequential(Block(c * 2, c * 4, 5, 2), Block(c * 4, c * 4, 3, 1),
                                   Block(c * 4, c * 4, 3, 1))
        self.out1 = plain_conv(c * 4, c * 8, 1)
        self.inner1 = plain_conv(c * 2, c * 4, 1, bias=True)
        self.out2 = plain_conv(c * 4, c * 4, 3)
        self.inner2 = plain_conv(c, c * 4, 1, bias=True)
        self.out3 = plain_conv(c * 4, c * 2, 3)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        intra = conv2
        out1 = self.out1(intra)
        intra = upsample_nearest_2x(intra) + self.inner1(conv1)
        out2 = self.out2(intra)
        intra = upsample_nearest_2x(intra) + self.inner2(conv0)
        outputs = {}
        for s, out in enumerate((out1, out2, self.out3(intra))):
            outputs[f"stage{s + 1}"], outputs[f"stage{s + 1}_c"] = out.chunk(2, dim=1)
        return outputs


# ------------------------------------------------------------- cost U-Nets


class UNetBranch(nn.Module):
    """A 3-level 3-D U-Net branch with a 2-channel head.  ``refine``: the
    4-plane variant whose bottom level (D = 1) runs 2-D convolutions."""

    def __init__(self, b: int = 8, refine: bool = False):
        super().__init__()
        self.refine = refine
        low = 2 if refine else 3
        self.conv0 = Block(2, b, dims=3)
        self.conv1 = Block(b, b * 2, stride=2, dims=3)
        self.conv2 = Block(b * 2, b * 2, dims=3)
        self.conv3 = Block(b * 2, b * 4, stride=2, dims=3)
        self.conv4 = Block(b * 4, b * 4, dims=3)
        self.conv5 = Block(b * 4, b * 8, stride=2, dims=low)
        self.conv6 = Block(b * 8, b * 8, dims=low)
        self.conv7 = Block(b * 8, b * 4, dims=low, transposed=True)
        self.conv9 = Block(b * 4, b * 2, dims=3, transposed=True)
        self.conv11 = Block(b * 2, b, dims=3, transposed=True)
        self.prob = plain_conv(b, 2, 3, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        if self.refine:
            conv4_2d = conv4.squeeze(2)
            y = self.conv6(self.conv5(conv4_2d))
            y = (conv4_2d + self.conv7(y)).unsqueeze(2)
        else:
            y = self.conv6(self.conv5(conv4))
            y = conv4 + self.conv7(y)
        y = conv2 + self.conv9(y)
        y = conv0 + self.conv11(y)
        return self.prob(y)


class UNet(nn.Module):
    """The dual U-Net: small and huge branches, 4 output channels."""

    def __init__(self, b: int = 8, refine: bool = False):
        super().__init__()
        self.cosR_small = UNetBranch(b, refine)
        self.cosR_huge = UNetBranch(b, refine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cosR_small(x), self.cosR_huge(x)], dim=1)


# ------------------------------------------------------------- geometry


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def inv3(m: torch.Tensor) -> torch.Tensor:
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def fuse_projection(proj2: torch.Tensor) -> torch.Tensor:
    """(..., 2, 4, 4) [extrinsics; intrinsics] -> (..., 4, 4) [[K R | K t], [0 | 1]]."""
    ext = proj2[..., 0, :, :]
    intr = proj2[..., 1, :3, :3]
    top = _matmul(intr, ext[..., :3, :4])
    return torch.cat([top, ext[..., 3:4, :]], dim=-2)


def invert_fused(fused: torch.Tensor) -> torch.Tensor:
    a = fused[..., :3, :3]
    b = fused[..., :3, 3:4]
    a_inv = inv3(a)
    top = torch.cat([a_inv, -_matmul(a_inv, b)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=fused.dtype,
                          device=fused.device).expand(*fused.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def relative_projections(proj2: torch.Tensor) -> torch.Tensor:
    """(B, V, 2, 4, 4) cameras -> (B, V-1, 3, 4) rows of src_v @ inv(ref)."""
    fused = fuse_projection(proj2.float())
    rel = _matmul(fused[:, 1:], invert_fused(fused[:, :1]))
    return rel[..., :3, :].contiguous()


def plane_sweep_coords(rel: torch.Tensor, depth: torch.Tensor, height: int, width: int):
    """Source pixel coordinates (px, py), each (B, D, H, W), of every
    reference pixel on every (B, D, H, W) hypothesis; z == 0 -> 1e-5."""
    b, d = rel.shape[0], depth.shape[1]
    rot, trans = rel[:, :3, :3], rel[:, :3, 3]
    dev = rel.device
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    rot_xyz = (rot[:, :, 0, None, None] * x + rot[:, :, 1, None, None] * y
               + rot[:, :, 2, None, None])
    depth = depth.expand(b, d, height, width)
    p = rot_xyz[:, :, None] * depth[:, None] + trans[:, :, None, None, None]
    z = p[:, 2]
    z = torch.where(z == 0.0, z + 1e-5, z)
    return p[:, 0] / z, p[:, 1] / z


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) sampled at pixel coordinates, zero outside the image,
    taps summed in the order (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1)."""
    b, h, w, c = img.shape
    x = x.float().clamp(-2.0, w + 1.0)
    y = y.float().clamp(-2.0, h + 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=img.device) * (h * w)).reshape(b, *([1] * (x.dim() - 1)))

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, c)
        return vals * (wgt * valid)[..., None]

    return (tap(x0i, y0i, (1 - wx) * (1 - wy)) + tap(x0i + 1, y0i, wx * (1 - wy))
            + tap(x0i, y0i + 1, (1 - wx) * wy) + tap(x0i + 1, y0i + 1, wx * wy))


def group_correlation(warped: torch.Tensor, ref: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Group g owns channels {2k+g}; the mean over k of warped * ref."""
    b, d, h, w, c = warped.shape
    wv = warped.reshape(b, d, h, w, c // groups, groups)
    rv = ref.reshape(b, 1, h, w, c // groups, groups)
    return (wv * rv).mean(dim=-2)


def cost_pass(feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The cost pass: (B, V, H, W, C) features, (B, V-1, 3, 4) projections,
    (B, D, H, W) hypotheses -> (B, D, H, W, 2), the source views' group
    correlations summed in view order.  The sampling grid carries no
    gradient."""
    _, v, h, w, _ = feats.shape
    ref = feats[:, 0]
    total = None
    for i in range(1, v):
        px, py = plane_sweep_coords(rel[:, i - 1], depth, h, w)
        warped = bilinear_sample(feats[:, i], px.detach(), py.detach())
        corr = group_correlation(warped, ref).float()
        total = corr if total is None else total + corr
    return total


# ---------------------------------------------------------------- sampling


def checkerboard(height: int, width: int, device=None) -> torch.Tensor:
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    return (y % 2) == (x % 2)


def _fan(start: torch.Tensor, step: torch.Tensor, ndepth: int) -> torch.Tensor:
    ar = torch.arange(ndepth, dtype=torch.float32, device=start.device)
    if start.dim() == 1:
        return start[:, None] + ar[None, :] * step[:, None]
    return start[:, None] + ar[None, :, None, None] * step[:, None]


def stage1_samples(depth_values, ndepth: int, height: int, width: int, inverse: bool):
    depth_values = depth_values.float()
    dmin, dmax = depth_values[:, 0], depth_values[:, -1]
    interval = (dmax - dmin) / (ndepth - 1)
    stage_interval = interval[0]
    cb = checkerboard(height, width, depth_values.device)[None, None]
    shape = (depth_values.shape[0], ndepth, height, width)
    if not inverse:
        flat = _fan(dmin, interval, ndepth)[:, :, None, None].expand(shape)
        return torch.where(cb, flat - stage_interval, flat + stage_interval), stage_interval

    def inv_fan(shift):
        lo, hi = dmin + shift, dmax + shift
        inv_step = (1.0 / hi - 1.0 / lo) / (ndepth - 1)
        return 1.0 / _fan(1.0 / lo, inv_step, ndepth)

    fan_n = inv_fan(-stage_interval)[:, :, None, None].expand(shape)
    fan_p = inv_fan(stage_interval)[:, :, None, None].expand(shape)
    return torch.where(cb, fan_n, fan_p), stage_interval


def cascade_samples(last_depth, ndepth: int, interval_px, inverse: bool):
    last_depth = last_depth.float()
    _, h, w = last_depth.shape
    cb = checkerboard(h, w, last_depth.device)[None, None]

    def window(lo_k: float, hi_k: float):
        lo = last_depth - lo_k * interval_px
        hi = last_depth + hi_k * interval_px
        if inverse:
            step = (1.0 / hi - 1.0 / lo) / (ndepth - 1)
            return 1.0 / _fan(1.0 / lo, step, ndepth)
        return _fan(lo, (hi - lo) / (ndepth - 1), ndepth)

    fan_n = window((ndepth + 2) / 2, (ndepth - 2) / 2)
    fan_p = window((ndepth - 2) / 2, (ndepth + 2) / 2)
    samples = torch.where(cb, fan_n, fan_p)
    return samples, (ndepth * interval_px / (ndepth - 1)).float()


# ------------------------------------------------------------ depth heads


def _parity(height: int, width: int, device):
    return torch.arange(height, device=device)[:, None], torch.arange(width, device=device)[None, :]


def _confidence(depth4, interval):
    std = torch.sqrt(depth4.var(dim=-1, correction=0)) + 1e-5
    return (2.0 * (torch.sigmoid(interval / std) - 0.5)).detach()


def _stack6(mn, mx):
    return torch.stack([3 * mn - 2 * mx, 2 * mn - mx, mn, mx, 2 * mx - mn, 3 * mx - 2 * mn],
                       dim=-1)


def head(cost_reg, depth_values, interval) -> dict[str, torch.Tensor]:
    """The first pass's head: softmax over D, soft-argmax per channel (4
    depths), the mod-4 x mod-2 checkerboard of the refine planes."""
    prob = torch.softmax(cost_reg.float(), dim=1)
    depth4 = (prob * depth_values[..., None]).sum(dim=1)
    small, huge = depth4[..., :2], depth4[..., 2:]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)
    s_min_d, s_max_d = 2 * s_min - s_max, 2 * s_max - s_min
    h_min_d, h_max_d = 2 * h_min - h_max, 2 * h_max - h_min
    small_stack, small_stack_d = _stack6(s_min, s_max), _stack6(s_min_d, s_max_d)
    huge_stack, huge_stack_d = _stack6(h_min, h_max), _stack6(h_min_d, h_max_d)
    y, x = _parity(depth4.shape[1], depth4.shape[2], depth4.device)
    y4, x2 = (y % 4)[None, :, :, None], (x % 2)[None, :, :, None]
    dv_c = torch.zeros_like(depth4)
    dv_c = torch.where((y4 == 0) & (x2 == 0), small_stack[..., :4], dv_c)
    dv_c = torch.where((y4 == 0) & (x2 == 1), small_stack[..., 2:], dv_c)
    dv_c = torch.where((y4 == 1) & (x2 == 0), huge_stack[..., 2:], dv_c)
    dv_c = torch.where((y4 == 1) & (x2 == 1), huge_stack[..., :4], dv_c)
    dv_c = torch.where((y4 == 2) & (x2 == 0), small_stack_d[..., :4], dv_c)
    dv_c = torch.where((y4 == 2) & (x2 == 1), small_stack_d[..., 2:], dv_c)
    dv_c = torch.where((y4 == 3) & (x2 == 0), huge_stack_d[..., 2:], dv_c)
    dv_c = torch.where((y4 == 3) & (x2 == 1), huge_stack_d[..., :4], dv_c)
    return {"prob_volume": prob, "depth_sub_plus": depth4,
            "depth_values_c": dv_c.permute(0, 3, 1, 2),
            "photometric_confidence": _confidence(depth4, interval),
            "depth_values": depth_values, "interval": interval}


def refine_head(cost_reg, depth_values, interval, alpha: float = 5.0):
    """The refine pass's head: sharpened softmax, then the 2x2 checkerboard
    picks the depth from {small min, small max, huge max, huge min}."""
    prob = torch.softmax(cost_reg.float() * alpha, dim=1)
    depth4 = (prob * depth_values[..., None]).sum(dim=1)
    small, huge = depth4[..., :2], depth4[..., 2:]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)
    y, x = _parity(depth4.shape[1], depth4.shape[2], depth4.device)
    y2, x2 = (y % 2)[None], (x % 2)[None]
    depth = torch.zeros_like(s_min)
    depth = torch.where((y2 == 0) & (x2 == 0), s_min, depth)
    depth = torch.where((y2 == 0) & (x2 == 1), s_max, depth)
    depth = torch.where((y2 == 1) & (x2 == 0), h_max, depth)
    depth = torch.where((y2 == 1) & (x2 == 1), h_min, depth)
    return {"depth": depth, "photometric_confidence_refine": _confidence(depth4, interval),
            "depth_sub_plus_refine": depth4}


# ------------------------------------------------------------------ model


class MVSNet(nn.Module):
    """The three-stage cascade, two cost passes a stage (a D-plane sweep on
    the main features, a 4-plane checkerboard refine on the "_c" features).
    ``train()`` / ``eval()`` pick the batch-norm mode."""

    def __init__(self, ndepths=(48, 32, 8), interval_ratio=(4.0, 2.0, 1.0),
                 inverse_depth: bool = False, base_channels: int = 8,
                 cr_base_channels=(8, 8, 8)):
        super().__init__()
        self.ndepths = tuple(ndepths)
        self.interval_ratio = tuple(interval_ratio)
        self.inverse_depth = inverse_depth
        self.feature = FeatureNet(base_channels)
        self.cost_regularization = nn.ModuleList([UNet(c) for c in cr_base_channels])
        self.cost_regularization_refine = nn.ModuleList(
            [UNet(c, refine=True) for c in cr_base_channels])

    def forward(self, imgs, proj_matrices, depth_values) -> dict:
        num_stage = len(self.ndepths)
        b, v, h, w, _ = imgs.shape
        depth_values = depth_values.float()
        depth_interval = (depth_values[0, -1] - depth_values[0, 0]) / depth_values.shape[1]
        x = imgs.float().reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2)
        feats = self.feature(x.contiguous())
        feats = {k: f.reshape(b, v, *f.shape[1:]).permute(0, 1, 3, 4, 2).to(
                     torch.float32, memory_format=torch.contiguous_format)
                 for k, f in feats.items()}
        outputs: dict = {}
        last_depth = None
        for s in range(num_stage):
            stage = f"stage{s + 1}"
            scale = 2 ** (num_stage - s - 1)
            sh, sw = h // scale, w // scale
            proj2 = proj_matrices[stage]
            if s == 0:
                samples, interval = stage1_samples(depth_values, self.ndepths[0], sh, sw,
                                                   self.inverse_depth)
            else:
                samples, interval = cascade_samples(
                    last_depth.detach(), self.ndepths[s],
                    self.interval_ratio[s] * depth_interval, self.inverse_depth)
                samples = F.interpolate(samples, size=(sh, sw), mode="bilinear",
                                        align_corners=False)

            def volume(key, dv):
                rel = relative_projections(proj2)
                return cost_pass(feats[key].float().contiguous(), rel, dv.contiguous())

            def regularize(cost, reg):
                out = reg(cost.to(torch.float32).permute(0, 4, 1, 2, 3).contiguous())
                return out.permute(0, 2, 3, 4, 1)

            cost_reg = regularize(volume(stage, samples), self.cost_regularization[s])
            stage_out = {**head(cost_reg, samples, interval), "depth_values": samples}
            dv_c = stage_out["depth_values_c"]
            cost_reg_c = regularize(volume(stage + "_c", dv_c),
                                    self.cost_regularization_refine[s])
            stage_out = {**refine_head(cost_reg_c, dv_c, interval), **stage_out}
            last_depth = stage_out["depth"]
            outputs[stage] = stage_out
            outputs.update(stage_out)
        return outputs


def build(config: dict, device) -> MVSNet:
    """The reference model of a configuration file's dict, uninitialised on
    ``device`` (the benchmark loads its weights)."""
    with torch.device("meta"):
        model = MVSNet(config["ndepths"], config["interval_ratio"], config["inverse_depth"],
                       config["base_channels"], config["cr_base_channels"])
    return model.to_empty(device=device)
