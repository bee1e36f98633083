"""Feature pyramid network (port of dmvsnet_tpu.models.feature_net,
unfolded branch).

3-scale encoder + top-down FPN whose double-width output heads split into
a main half (first cost pass) and a "_c" half (checkerboard refine pass).
With base_channels=8: stage1 32(+32) at 1/4, stage2 16(+16) at 1/2,
stage3 8(+8) at full resolution.  Module names follow the reference
layout (``conv0.0`` ... ``conv2.2``, ``out1..3``, ``inner1..2``).
``dtype`` is every block's compute dtype (``models/blocks.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from dmvsnet_tpu_torch.models.blocks import ConvBlock, PlainConv, upsample_nearest_2x


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels

        def conv(cin, cout, k, s):
            return ConvBlock(cin, cout, k, s, dtype=dtype)

        self.conv0 = nn.Sequential(conv(3, c, 3, 1), conv(c, c, 3, 1))
        self.conv1 = nn.Sequential(conv(c, c * 2, 5, 2), conv(c * 2, c * 2, 3, 1),
                                   conv(c * 2, c * 2, 3, 1))
        self.conv2 = nn.Sequential(conv(c * 2, c * 4, 5, 2), conv(c * 4, c * 4, 3, 1),
                                   conv(c * 4, c * 4, 3, 1))
        self.out1 = PlainConv(c * 4, c * 8, kernel=1, dtype=dtype)
        self.inner1 = PlainConv(c * 2, c * 4, kernel=1, use_bias=True, dtype=dtype)
        self.out2 = PlainConv(c * 4, c * 4, kernel=3, dtype=dtype)
        self.inner2 = PlainConv(c, c * 4, kernel=1, use_bias=True, dtype=dtype)
        self.out3 = PlainConv(c * 4, c * 2, kernel=3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, 3, H, W) -> {stage1..3, stage1_c..3_c}, each (N, C, h, w)."""
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        outputs = {}
        intra = conv2
        outputs["stage1"], outputs["stage1_c"] = self.out1(intra).chunk(2, dim=1)
        intra = upsample_nearest_2x(intra) + self.inner1(conv1)
        outputs["stage2"], outputs["stage2_c"] = self.out2(intra).chunk(2, dim=1)
        intra = upsample_nearest_2x(intra) + self.inner2(conv0)
        outputs["stage3"], outputs["stage3_c"] = self.out3(intra).chunk(2, dim=1)
        return outputs
