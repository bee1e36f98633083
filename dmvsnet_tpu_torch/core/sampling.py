"""Depth-hypothesis samplers with checkerboard offsets (port of
dmvsnet_tpu.core.sampling).

* stage 1: a uniform (or inverse-depth uniform) fan over the global range,
  every pixel shifted by -/+ stage_interval on a 2x2 checkerboard;
* cascade stages: per-pixel asymmetric windows around the previous depth,
  the "minus" window on one checkerboard phase and its mirror on the
  other, with inverse-depth twins.

``uniform_samples`` and ``uniform_window_samples`` are CasMVSNet's plain
hypotheses (``get_depth_range_samples``), which TransMVSNet takes: one
uniform fan over the range at stage 1, then a symmetric window around the
previous depth, laid out at full resolution and resized to the stage's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def checkerboard(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W) bool mask, True where row-parity == col-parity."""
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    return (y % 2) == (x % 2)


def _fan(start: torch.Tensor, step: torch.Tensor, ndepth: int) -> torch.Tensor:
    """start[..., None] + arange(D) * step[..., None] with D in axis 1."""
    ar = torch.arange(ndepth, dtype=torch.float32, device=start.device)
    if start.dim() == 1:
        return start[:, None] + ar[None, :] * step[:, None]
    return start[:, None] + ar[None, :, None, None] * step[:, None]


def stage1_samples(
    depth_values: torch.Tensor, ndepth: int, height: int, width: int,
    inverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-stage hypotheses from the global (B, D0) depth range.

    Returns:
      samples: (B, ndepth, H, W) float32.
      stage_interval: 0-d tensor, (max-min)/(ndepth-1) of batch element 0.
    """
    depth_values = depth_values.float()
    dmin = depth_values[:, 0]
    dmax = depth_values[:, -1]
    interval = (dmax - dmin) / (ndepth - 1)
    stage_interval = interval[0]
    cb = checkerboard(height, width, depth_values.device)[None, None]
    shape = (depth_values.shape[0], ndepth, height, width)

    if not inverse:
        flat = _fan(dmin, interval, ndepth)[:, :, None, None].expand(shape)
        return torch.where(cb, flat - stage_interval, flat + stage_interval), stage_interval

    def inv_fan(shift):
        lo = dmin + shift
        hi = dmax + shift
        inv_step = (1.0 / hi - 1.0 / lo) / (ndepth - 1)
        return 1.0 / _fan(1.0 / lo, inv_step, ndepth)

    fan_n = inv_fan(-stage_interval)[:, :, None, None].expand(shape)
    fan_p = inv_fan(stage_interval)[:, :, None, None].expand(shape)
    return torch.where(cb, fan_n, fan_p), stage_interval


def cascade_samples(
    last_depth: torch.Tensor, ndepth: int, interval_px: torch.Tensor,
    inverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel hypotheses around the previous stage's (B, H, W) depth.

    minus: [d - (D+2)/2 * ivl,  d + (D-2)/2 * ivl]
    plus : [d - (D-2)/2 * ivl,  d + (D+2)/2 * ivl]
    sampled uniformly in depth (or in 1/d for ``inverse``); the
    checkerboard takes "minus" where row-parity == col-parity.

    Returns:
      samples: (B, ndepth, H, W); stage_interval 0-d tensor
        ``ndepth * interval_px / (ndepth - 1)``.
    """
    last_depth = last_depth.float()
    _, h, w = last_depth.shape
    cb = checkerboard(h, w, last_depth.device)[None, None]

    def window(lo_k: float, hi_k: float) -> torch.Tensor:
        lo = last_depth - lo_k * interval_px
        hi = last_depth + hi_k * interval_px
        if inverse:
            step = (1.0 / hi - 1.0 / lo) / (ndepth - 1)
            return 1.0 / _fan(1.0 / lo, step, ndepth)
        return _fan(lo, (hi - lo) / (ndepth - 1), ndepth)

    fan_n = window((ndepth + 2) / 2, (ndepth - 2) / 2)
    fan_p = window((ndepth - 2) / 2, (ndepth + 2) / 2)
    samples = torch.where(cb, fan_n, fan_p)
    stage_interval = (ndepth * interval_px / (ndepth - 1)).float()
    return samples, stage_interval


def upsample_depth_samples(samples: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear-resize (B, D, h, w) samples to (B, D, height, width),
    half-pixel centres (``align_corners=False``)."""
    return F.interpolate(samples, size=(height, width), mode="bilinear",
                         align_corners=False)


def uniform_samples(depth_values: torch.Tensor, ndepth: int, height: int,
                    width: int) -> torch.Tensor:
    """Stage-1 hypotheses of the cascade without checkerboard: ``ndepth``
    planes from ``depth_values[:, 0]`` to ``depth_values[:, -1]`` in steps
    of (max - min) / (ndepth - 1), as (B, ndepth, height, width) fp32."""
    depth_values = depth_values.float()
    dmin, dmax = depth_values[:, 0], depth_values[:, -1]
    flat = _fan(dmin, (dmax - dmin) / (ndepth - 1), ndepth)
    return flat[:, :, None, None].expand(depth_values.shape[0], ndepth, height, width)


def uniform_window_samples(last_depth: torch.Tensor, ndepth: int, interval: torch.Tensor,
                           full: tuple[int, int], height: int, width: int) -> torch.Tensor:
    """Later-stage hypotheses of the cascade without checkerboard: the
    previous (B, h, w) depth resized bilinearly to the ``full`` image size
    (half-pixel centres), ``ndepth`` uniform planes over
    [d - ndepth/2 * interval, d + ndepth/2 * interval] there, then resized
    bilinearly to (height, width).  (B, ndepth, height, width) fp32."""
    depth = F.interpolate(last_depth.float()[:, None], size=full, mode="bilinear",
                          align_corners=False)[:, 0]
    lo = depth - ndepth / 2 * interval
    hi = depth + ndepth / 2 * interval
    samples = _fan(lo, (hi - lo) / (ndepth - 1), ndepth)
    if tuple(full) == (height, width):
        return samples
    return upsample_depth_samples(samples, height, width)
