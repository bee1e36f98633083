"""Feature pyramid network (port of dmvsnet_tpu.models.feature_net).

3-scale encoder + top-down FPN whose double-width output heads split into
a main half (first cost pass) and a "_c" half (checkerboard refine pass).
With base_channels=8: stage1 32(+32) at 1/4, stage2 16(+16) at 1/2,
stage3 8(+8) at full resolution.  Module names follow the reference
layout (``conv0.0`` ... ``conv2.2``, ``out1..3``, ``inner1..2``).
``dtype`` is every block's compute dtype (``models/blocks.py``).

``fold_level0`` (an attribute, default False as in the JAX package): with
even H and W, and no cost count running (``folded.level0``, which asks
``blocks.takes_fold``), the full-resolution level runs in 2x2 folded form
(``models/folded.py``) over the same parameters: ``conv0.0``, ``conv0.1``,
``conv1.0`` (k5, stride 2: plain out), and ``inner2`` / ``out3``, where the
nearest 2x upsample of the half-resolution map is its tiling over the four
fold phases.  The blocks run through ``blocks._Block`` in either plan,
which owns the norm and its fold into the convolution.

The encoder and the top-down path are ``FPN``'s, which takes its three
output heads as modules; ``FeatureNet`` gives it DMVSNet's plain heads, and
``models/transmvsnet.ARFFeatureNet`` TransMVSNet's deformable ones.
"""

from __future__ import annotations

import torch
from torch import nn

from dmvsnet_tpu_torch.models import folded
from dmvsnet_tpu_torch.models.blocks import ConvBlock, PlainConv, upsample_nearest_2x


class FPN(nn.Module):
    """The 3-scale encoder and the top-down path around three output heads
    (``out1`` at 1/4, ``out2`` at 1/2, ``out3`` at full resolution, each
    taking the 32-wide FPN map for base 8).  The modules are registered
    in the order conv0, conv1, conv2, out1, inner1, out2, inner2, out3, so
    the state dict keeps one order whatever the heads."""

    def __init__(self, heads: tuple[nn.Module, nn.Module, nn.Module], base_channels: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels

        def conv(cin, cout, k, s):
            return ConvBlock(cin, cout, k, s, dtype=dtype)

        self.conv0 = nn.Sequential(conv(3, c, 3, 1), conv(c, c, 3, 1))
        self.conv1 = nn.Sequential(conv(c, c * 2, 5, 2), conv(c * 2, c * 2, 3, 1),
                                   conv(c * 2, c * 2, 3, 1))
        self.conv2 = nn.Sequential(conv(c * 2, c * 4, 5, 2), conv(c * 4, c * 4, 3, 1),
                                   conv(c * 4, c * 4, 3, 1))
        self.out1 = heads[0]
        self.inner1 = PlainConv(c * 2, c * 4, kernel=1, use_bias=True, dtype=dtype)
        self.out2 = heads[1]
        self.inner2 = PlainConv(c, c * 4, kernel=1, use_bias=True, dtype=dtype)
        self.out3 = heads[2]

    def _lower(self, conv1: torch.Tensor):
        """(out1, out2, the 1/2-resolution FPN map) from the 1/2-resolution
        encoder output."""
        conv2 = self.conv2(conv1)
        intra = conv2
        out1 = self.out1(intra)
        intra = upsample_nearest_2x(intra) + self.inner1(conv1)
        return out1, self.out2(intra), intra

    def _unfolded(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        conv0 = self.conv0(x)
        out1, out2, intra = self._lower(self.conv1(conv0))
        intra = upsample_nearest_2x(intra) + self.inner2(conv0)
        return out1, out2, self.out3(intra)


class FeatureNet(FPN):
    def __init__(self, base_channels: int = 8, dtype: torch.dtype = torch.float32,
                 fold_level0: bool = False):
        c = base_channels
        super().__init__((PlainConv(c * 4, c * 8, kernel=1, dtype=dtype),
                          PlainConv(c * 4, c * 4, kernel=3, dtype=dtype),
                          PlainConv(c * 4, c * 2, kernel=3, dtype=dtype)), c, dtype)
        self.fold_level0 = fold_level0

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (N, 3, H, W) -> {stage1..3, stage1_c..3_c}, each (N, C, h, w)."""
        even = x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0
        heads = (self._folded if folded.level0(self, x.shape, even) else self._unfolded)(x)
        outputs = {}
        for s, out in enumerate(heads):
            outputs[f"stage{s + 1}"], outputs[f"stage{s + 1}_c"] = out.chunk(2, dim=1)
        return outputs

    def _folded(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        conv0 = folded.conv_block(self.conv0[1], folded.conv_block(self.conv0[0], folded.fold2d(x)))
        x1 = folded.conv_block(self.conv1[0], conv0)              # plain, 1/2 resolution
        out1, out2, intra = self._lower(self.conv1[2](self.conv1[1](x1)))
        intra = intra.repeat(1, 4, 1, 1) + folded.plain_conv(self.inner2, conv0)
        return out1, out2, folded.unfold2d(folded.plain_conv(self.out3, intra),
                                           self.out3.out_channels)
