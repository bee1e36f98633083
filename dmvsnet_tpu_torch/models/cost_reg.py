"""Cost-volume regularization: dual ("small"/"huge" depth cell) 3D U-Nets
(port of dmvsnet_tpu.models.cost_reg).

Each branch is a 3-level 3D U-Net (stride-2 at each level, additive skips)
with a 2-channel head; the refine variant collapses its 4-plane depth
axis at the bottleneck and runs 2D convs there.  Cost volumes are
(B, C, D, H, W) here; outputs (B, 4, D, H, W) with channels
[small0, small1, huge0, huge1].  ``dtype`` is every block's compute dtype
(``models/blocks.py``).

``fold_level0`` (an attribute, so one model switches plans): a branch runs
its full-resolution level (``conv0``, ``conv1``, ``conv11``, ``prob``) in
folded form (``models/folded.py``) over the same parameters where
``folded.level0`` says so: ``fold_level0`` is set,
``folded.use_folded_level0`` holds for the input and no cost count runs
(``blocks.takes_fold``); the levels below run as they are.  Every block of
either plan runs through ``blocks._Block``, which owns the norm
(``blocks._BiasedRunningVar``) and its fold into the convolution.  The
port's default is False: the JAX package's default, True, was chosen on a
TPU, and routing on the card comes from measurements on the card.

``AggWeightNetVolume`` is the per-voxel view-weight net of
``agg_mode="adaptive"``: two 1x1x1 ConvBlocks (batch norm, ReLU), 2 -> 1 -> 1.
Where both fold their eval norm, ``gate_params`` packs the net for the
gated cost pass (``ops/warp_correlate.aggregate_cost_volume_gated``), which
computes it inside the pass.
"""

from __future__ import annotations

import torch
from torch import nn

from dmvsnet_tpu_torch.models import folded
from dmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock, PlainConv


class _Branch(nn.Module):
    """A cost U-Net branch: its full-resolution level (``conv0``, ``conv1``,
    ``conv11``, ``prob``) around the levels below (``_middle``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if folded.level0(self, x.shape, folded.use_folded_level0(x)):
            return self._folded(x)
        return self._unfolded(x)

    def _unfolded(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        y = self._middle(self.conv2(self.conv1(conv0)))
        y = conv0 + self.conv11(y)
        return self.prob(y)

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[2]
        conv0 = folded.conv_block(self.conv0, folded.fold3d(x), d)       # folded
        y = self._middle(self.conv2(folded.conv_block(self.conv1, conv0, d)))
        y = conv0 + folded.deconv_block(self.conv11, y, d // 2)           # folded
        return folded.unfold3d(folded.plain_conv(self.prob, y, d), d, self.prob.out_channels)


class CostRegNetPart(_Branch):
    """A 3-D U-Net branch with an ``out_channels``-wide head (2 in DMVSNet's
    dual U-Nets; 1 in, 1 out as TransMVSNet's, CasMVSNet's ``CostRegNet``)."""

    def __init__(self, in_channels: int = 2, base_channels: int = 8,
                 dtype: torch.dtype = torch.float32, fold_level0: bool = False,
                 out_channels: int = 2):
        super().__init__()
        self.fold_level0 = fold_level0
        b = base_channels
        self.conv0 = ConvBlock(in_channels, b, dims=3, dtype=dtype)
        self.conv1 = ConvBlock(b, b * 2, stride=2, dims=3, dtype=dtype)
        self.conv2 = ConvBlock(b * 2, b * 2, dims=3, dtype=dtype)
        self.conv3 = ConvBlock(b * 2, b * 4, stride=2, dims=3, dtype=dtype)
        self.conv4 = ConvBlock(b * 4, b * 4, dims=3, dtype=dtype)
        self.conv5 = ConvBlock(b * 4, b * 8, stride=2, dims=3, dtype=dtype)
        self.conv6 = ConvBlock(b * 8, b * 8, dims=3, dtype=dtype)
        self.conv7 = DeconvBlock(b * 8, b * 4, dims=3, dtype=dtype)
        self.conv9 = DeconvBlock(b * 4, b * 2, dims=3, dtype=dtype)
        self.conv11 = DeconvBlock(b * 2, b, dims=3, dtype=dtype)
        self.prob = PlainConv(b, out_channels, kernel=3, dims=3, dtype=dtype)

    def _middle(self, conv2: torch.Tensor) -> torch.Tensor:
        conv4 = self.conv4(self.conv3(conv2))
        y = self.conv6(self.conv5(conv4))
        y = conv4 + self.conv7(y)
        return conv2 + self.conv9(y)


class CostRegNetPartRefine(_Branch):
    """Refine branch: 2D bottleneck at the collapsed D=1 level (the input
    always has D=4)."""

    def __init__(self, in_channels: int = 2, base_channels: int = 8,
                 dtype: torch.dtype = torch.float32, fold_level0: bool = False):
        super().__init__()
        self.fold_level0 = fold_level0
        b = base_channels
        self.conv0 = ConvBlock(in_channels, b, dims=3, dtype=dtype)
        self.conv1 = ConvBlock(b, b * 2, stride=2, dims=3, dtype=dtype)
        self.conv2 = ConvBlock(b * 2, b * 2, dims=3, dtype=dtype)
        self.conv3 = ConvBlock(b * 2, b * 4, stride=2, dims=3, dtype=dtype)
        self.conv4 = ConvBlock(b * 4, b * 4, dims=3, dtype=dtype)
        self.conv5 = ConvBlock(b * 4, b * 8, stride=2, dims=2, dtype=dtype)
        self.conv6 = ConvBlock(b * 8, b * 8, dims=2, dtype=dtype)
        self.conv7 = DeconvBlock(b * 8, b * 4, dims=2, dtype=dtype)
        self.conv9 = DeconvBlock(b * 4, b * 2, dims=3, dtype=dtype)
        self.conv11 = DeconvBlock(b * 2, b, dims=3, dtype=dtype)
        self.prob = PlainConv(b, 2, kernel=3, dims=3, dtype=dtype)

    def _middle(self, conv2: torch.Tensor) -> torch.Tensor:   # conv2: D=2
        conv4 = self.conv4(self.conv3(conv2))                  # D=1
        conv4_2d = conv4.squeeze(2)
        y = self.conv6(self.conv5(conv4_2d))
        y = (conv4_2d + self.conv7(y)).unsqueeze(2)            # D=1
        return conv2 + self.conv9(y)


class CostRegNet(nn.Module):
    """Dual branch: small + huge concatenated to 4 channels."""

    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32,
                 fold_level0: bool = False):
        super().__init__()
        self.cosR_small = CostRegNetPart(2, base_channels, dtype, fold_level0)
        self.cosR_huge = CostRegNetPart(2, base_channels, dtype, fold_level0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cosR_small(x), self.cosR_huge(x)], dim=1)


class CostRegNetRefine(nn.Module):
    """Dual refine branch."""

    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32,
                 fold_level0: bool = False):
        super().__init__()
        self.cosR_small = CostRegNetPartRefine(2, base_channels, dtype, fold_level0)
        self.cosR_huge = CostRegNetPartRefine(2, base_channels, dtype, fold_level0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cosR_small(x), self.cosR_huge(x)], dim=1)


class AggWeightNetVolume(nn.Module):
    """Per-voxel aggregation weight logits of the adaptive cost mode (port
    of ``dmvsnet_tpu.models.cost_reg.AggWeightNetVolume``): (B, 2, D, H, W)
    -> (B, 1, D, H, W)."""

    def __init__(self, in_channels: int = 2, hid_channels: int = 1, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w0 = ConvBlock(in_channels, hid_channels, kernel=1, dims=3, dtype=dtype)
        self.w1 = ConvBlock(hid_channels, out_channels, kernel=1, dims=3, dtype=dtype)

    _packed = None  # (the blocks' folded pairs, the packed gate), set by gate_params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w1(self.w0(x))

    def gate_params(self) -> torch.Tensor | None:
        """The net as the gated cost pass takes it: the (5,) fp32 tensor
        ``w00, w01, b0, a1, b1`` (``ops/warp_correlate
        .gated_warp_correlate_plain``) where the net is 2 -> 1 -> 1 and both
        blocks fold their eval norm into the convolution (``_Block._folds``:
        eval norms, fp32, autograd off, no cost count), else None.  Packed
        on the device from the blocks' folded pairs (``_Block._folded``)
        and kept until a block forms its pair anew."""
        shapes = (tuple(self.w0.conv.weight.shape), tuple(self.w1.conv.weight.shape))
        if shapes != ((1, 2, 1, 1, 1), (1, 1, 1, 1, 1)) or not (self.w0._folds()
                                                               and self.w1._folds()):
            return None
        folds = (*self.w0._folded(), *self.w1._folded())
        if self._packed is None or any(a is not b for a, b in zip(self._packed[0], folds)):
            self._packed = (folds, torch.cat([f.reshape(-1) for f in folds]).float())
        return self._packed[1]
