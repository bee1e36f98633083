"""Depth-map quality metrics (port of dmvsnet_tpu.losses.metrics).

Per-image masked reductions (an image with an empty mask contributes 0,
not NaN), averaged over the batch.
"""

from __future__ import annotations

import torch


def _per_image_masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over masked pixels per image; 0 where the mask is empty."""
    count = mask.sum(dim=(1, 2))
    total = (values * mask).sum(dim=(1, 2))
    per_image = torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))
    return per_image.mean()


def abs_depth_error(depth_est, depth_gt, mask) -> torch.Tensor:
    """Mean absolute depth error over masked pixels, per-image averaged."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask.float())


def threshold_error(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    """Fraction of masked pixels with |error| > thres, per-image averaged."""
    err = ((depth_est - depth_gt).abs() > thres).float()
    return _per_image_masked_mean(err, mask.float())


def standard_metrics(depth_est, depth_gt, mask) -> dict[str, torch.Tensor]:
    """The Th2/Th4/Th8 + abs-err bundle logged by the trainer."""
    return {
        "abs_depth_error": abs_depth_error(depth_est, depth_gt, mask),
        "thres2mm_error": threshold_error(depth_est, depth_gt, mask, 2.0),
        "thres4mm_error": threshold_error(depth_est, depth_gt, mask, 4.0),
        "thres8mm_error": threshold_error(depth_est, depth_gt, mask, 8.0),
    }
