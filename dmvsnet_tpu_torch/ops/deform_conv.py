"""Modulated deformable convolution (DCNv2, Zhu et al., CVPR 2019) in plain
PyTorch: TransMVSNet's adaptive receptive field (``models/transmvsnet``).

For a 3x3 kernel with taps p_k (k = 3 * ky + kx, p_k = (ky - 1, kx - 1)),

    y(p) = b + sum_k W_k m_k(p) x(p + p_k + dp_k(p)),

where ``conv_offset_mask``, a 3x3 convolution with bias and 27 outputs,
gives per pixel the offsets dp_k = (dy_k, dx_k) in its first 18 channels
(channel 2k is dy_k, 2k + 1 is dx_k: DCNv2's layout) and the mask logits
in its last 9, m_k = sigmoid(logit_k).  x is sampled bilinearly with zeros
outside the image (``ops/warp.bilinear_sample``).  The sum runs tap by
tap: each tap's sampled, masked input (N, H, W, C_in) goes through W_k
and is added to the output, so no 9x column buffer is built.  A TPU has no
counterpart in the JAX package; no CUDA kernel is written for it yet.

``stats()`` counts the calls and the sampled taps (N * H * W * 9 a call,
each a bilinear sample of C_in channels) since the last reset.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F
from torch import nn

from dmvsnet_tpu_torch.ops import warp

_STATS = {"calls": 0, "taps": 0}
_STATS_LOCK = threading.Lock()


def stats() -> dict[str, int]:
    """Deformable convolutions since the last reset: ``calls`` and
    ``taps``, the bilinear samples they took."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def deform_conv2d(x: torch.Tensor, offset_mask: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The modulated deformable convolution of ``x`` (N, C_in, H, W) by
    ``weight`` (C_out, C_in, 3, 3) and ``bias`` (C_out,), stride 1, padding 1,
    with ``offset_mask`` (N, 27, H, W) the output of the offset and mask
    convolution.  Returns (N, C_out, H, W) in ``weight``'s dtype, stored
    channels-last."""
    n, c, h, w = x.shape
    taps = weight.shape[2] * weight.shape[3]
    if tuple(weight.shape[2:]) != (3, 3) or offset_mask.shape[1] != 3 * taps:
        raise ValueError(f"a 3x3 kernel and 27 offset and mask channels, got weight "
                         f"{tuple(weight.shape)} and offset_mask {tuple(offset_mask.shape)}")
    mask = torch.sigmoid(offset_mask[:, 2 * taps:].float())
    img = x.permute(0, 2, 3, 1).contiguous()
    rows = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    out = None
    for k in range(taps):
        ky, kx = divmod(k, 3)
        py = rows + (ky - 1) + offset_mask[:, 2 * k].float()
        px = cols + (kx - 1) + offset_mask[:, 2 * k + 1].float()
        sampled = warp.bilinear_sample(img, px, py) * mask[:, k, :, :, None]
        term = sampled.to(weight.dtype) @ weight[:, :, ky, kx].t()
        out = term if out is None else out + term
    with _STATS_LOCK:
        _STATS["calls"] += 1
        _STATS["taps"] += n * h * w * taps
    return (out + bias).permute(0, 3, 1, 2)


class DeformConv2d(nn.Conv2d):
    """A 3x3 modulated deformable convolution (stride 1, padding 1, with
    bias), DCNv2's ``DCN`` module: ``weight`` and ``bias`` as a
    convolution's, then ``conv_offset_mask``.  ``compute_dtype`` is what the
    input, the weights and the output are cast to (fp32 parameters), as the
    port's other convolutions do (``models/blocks``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 3, padding=1, bias=True)
        self.conv_offset_mask = nn.Conv2d(in_channels, 27, 3, padding=1, bias=True)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        om = self.conv_offset_mask
        offset_mask = F.conv2d(x, om.weight.to(dt), om.bias.to(dt), padding=1)
        return deform_conv2d(x, offset_mask, self.weight.to(dt), self.bias.to(dt))
