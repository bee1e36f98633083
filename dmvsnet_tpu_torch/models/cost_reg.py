"""Cost-volume regularization: dual ("small"/"huge" depth cell) 3D U-Nets
(port of dmvsnet_tpu.models.cost_reg, unfolded layout).

Each branch is a 3-level 3D U-Net (stride-2 at each level, additive skips)
with a 2-channel head; the refine variant collapses its 4-plane depth
axis at the bottleneck and runs 2D convs there.  Cost volumes are
(B, C, D, H, W) here; outputs (B, 4, D, H, W) with channels
[small0, small1, huge0, huge1].
"""

from __future__ import annotations

import torch
from torch import nn

from dmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock, PlainConv


class CostRegNetPart(nn.Module):
    def __init__(self, in_channels: int = 2, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = ConvBlock(in_channels, b, dims=3)
        self.conv1 = ConvBlock(b, b * 2, stride=2, dims=3)
        self.conv2 = ConvBlock(b * 2, b * 2, dims=3)
        self.conv3 = ConvBlock(b * 2, b * 4, stride=2, dims=3)
        self.conv4 = ConvBlock(b * 4, b * 4, dims=3)
        self.conv5 = ConvBlock(b * 4, b * 8, stride=2, dims=3)
        self.conv6 = ConvBlock(b * 8, b * 8, dims=3)
        self.conv7 = DeconvBlock(b * 8, b * 4, dims=3)
        self.conv9 = DeconvBlock(b * 4, b * 2, dims=3)
        self.conv11 = DeconvBlock(b * 2, b, dims=3)
        self.prob = PlainConv(b, 2, kernel=3, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        y = self.conv6(self.conv5(conv4))
        y = conv4 + self.conv7(y)
        y = conv2 + self.conv9(y)
        y = conv0 + self.conv11(y)
        return self.prob(y)


class CostRegNetPartRefine(nn.Module):
    """Refine branch: 2D bottleneck at the collapsed D=1 level (the input
    always has D=4)."""

    def __init__(self, in_channels: int = 2, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = ConvBlock(in_channels, b, dims=3)
        self.conv1 = ConvBlock(b, b * 2, stride=2, dims=3)
        self.conv2 = ConvBlock(b * 2, b * 2, dims=3)
        self.conv3 = ConvBlock(b * 2, b * 4, stride=2, dims=3)
        self.conv4 = ConvBlock(b * 4, b * 4, dims=3)
        self.conv5 = ConvBlock(b * 4, b * 8, stride=2, dims=2)
        self.conv6 = ConvBlock(b * 8, b * 8, dims=2)
        self.conv7 = DeconvBlock(b * 8, b * 4, dims=2)
        self.conv9 = DeconvBlock(b * 4, b * 2, dims=3)
        self.conv11 = DeconvBlock(b * 2, b, dims=3)
        self.prob = PlainConv(b, 2, kernel=3, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)                                  # D=4
        conv2 = self.conv2(self.conv1(conv0))                  # D=2
        conv4 = self.conv4(self.conv3(conv2))                  # D=1
        conv4_2d = conv4.squeeze(2)
        y = self.conv6(self.conv5(conv4_2d))
        y = (conv4_2d + self.conv7(y)).unsqueeze(2)            # D=1
        y = conv2 + self.conv9(y)
        y = conv0 + self.conv11(y)
        return self.prob(y)


class CostRegNet(nn.Module):
    """Dual branch: small + huge concatenated to 4 channels."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        self.cosR_small = CostRegNetPart(2, base_channels)
        self.cosR_huge = CostRegNetPart(2, base_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cosR_small(x), self.cosR_huge(x)], dim=1)


class CostRegNetRefine(nn.Module):
    """Dual refine branch."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        self.cosR_small = CostRegNetPartRefine(2, base_channels)
        self.cosR_huge = CostRegNetPartRefine(2, base_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.cosR_small(x), self.cosR_huge(x)], dim=1)
