"""Conv / deconv / batch-norm building blocks (port of
dmvsnet_tpu.models.blocks), channels-first as PyTorch convolutions want.

* convolutions pad k//2 on each side;
* transposed convolutions are ``ConvTranspose{2,3}d(k, stride=2,
  padding=k//2, output_padding=1)``: output exactly 2x the input;
* batch norm uses eps 1e-5 and momentum 0.1 (flax's momentum=0.9 is the
  same update written the other way round); in train mode the running
  variance is updated with the BIASED batch variance, as flax does
  (``torch.nn.BatchNorm*`` would use the unbiased one);
* a conv has a bias only when it has no batch norm.

Attribute names follow the reference layout (``.conv`` and ``.bn``), so a
reference-named state dict loads as is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


class _BiasedRunningVar:
    """Train-mode batch norm whose running variance follows the JAX
    package: ``var <- (1 - m) var + m * biased batch variance``.

    ``torch.nn.BatchNorm*`` normalises with the biased variance but updates
    the running variance with the unbiased one, n/(n-1) times larger (n =
    elements per channel).  At the bottom of a cost U-Net n is a few dozen
    at full size and a handful in small tests, so the factor is visible.
    The fused call updates a copy of the running variance (autograd keeps
    that copy for the backward, so the module's buffer can change in
    place), and the buffer takes the corrected update, per channel.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        m = self.momentum
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, m, self.eps)
        n = x.numel() // x.shape[1]
        # torch wrote var = (1-m) old + m b n/(n-1), b the biased variance;
        # (n-1)/n var + (1-m)/n old = (1-m) old + m b
        with torch.no_grad():
            self.running_var.mul_((1.0 - m) / n).add_(var, alpha=(n - 1) / n)
            self.num_batches_tracked += 1
        return y


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BiasedRunningVar, nn.BatchNorm3d):
    pass


_BN = {2: BatchNorm2d, 3: BatchNorm3d}


class ConvBlock(nn.Module):
    """Conv{2,3}d + optional BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dims: int = 2, relu: bool = True, bn: bool = True):
        super().__init__()
        self.conv = _CONV[dims](in_ch, out_ch, kernel, stride=stride,
                                padding=kernel // 2, bias=not bn)
        self.bn = _BN[dims](out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


class DeconvBlock(nn.Module):
    """ConvTranspose{2,3}d(k, stride=2, padding=k//2, output_padding=1)
    + optional BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dims: int = 2,
                 relu: bool = True, bn: bool = True):
        super().__init__()
        self.conv = _DECONV[dims](in_ch, out_ch, kernel, stride=2,
                                  padding=kernel // 2, output_padding=1,
                                  bias=not bn)
        self.bn = _BN[dims](out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


def PlainConv(in_ch: int, out_ch: int, kernel: int = 1, dims: int = 2,
              use_bias: bool = False) -> nn.Module:
    """A bare conv (no bn / relu) with k//2 padding, as the FPN heads and
    the probability heads use."""
    return _CONV[dims](in_ch, out_ch, kernel, padding=kernel // 2, bias=use_bias)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over the last two axes (N, C, H, W)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of every conv and batch norm in ``model``.

    Convs: U(+-1/sqrt(fan_in)) for weights and biases, PyTorch's default
    conv init (fan_in = weight.shape[1] * prod(kernel)).  Batch norm:
    weight 1, bias 0, running mean 0, running var 1.  The numbers come
    from ``generator`` alone, on the CPU, so a seed gives the same weights
    on every device.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            bound = 1.0 / math.sqrt(m.weight.shape[1] * math.prod(m.weight.shape[2:]))
            for p in (m.weight, m.bias):
                if p is not None:
                    r = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                    p.copy_((r * 2.0 - 1.0) * bound)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            m.running_mean.fill_(0.0)
            m.running_var.fill_(1.0)
            m.num_batches_tracked.fill_(0)
    return model
