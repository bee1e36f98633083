"""Alternate depth-supervision losses: classification / gfocal /
unification (port of dmvsnet_tpu.losses.alt_losses).

These modes are argparse choices that no shipped config uses; they follow
the JAX package, including its quirk of feeding the *softmaxed*
prob_volume into a with-logits BCE.

Layouts: prob_volume (B, D, H, W, C=4) (the per-channel loss is averaged),
depth_values (B, D, H, W).
"""

from __future__ import annotations

import math

import torch


def _bce_with_logits(logits, targets, pos_weight=None):
    """Numerically-stable BCE-with-logits."""
    max_val = (-logits).clamp(min=0)
    log_term = max_val + torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val))
    if pos_weight is None:
        return logits - logits * targets + log_term
    log_weight = 1 + (pos_weight - 1) * targets
    return logits - logits * targets + log_weight * log_term


def _gt_index_volume(depth_values, depth_gt, interval, centered: bool):
    gt = depth_gt[:, None]
    if centered:
        return (((depth_values - interval / 2) <= gt)
                & ((depth_values + interval / 2) > gt)).float()
    return ((depth_values <= gt) & ((depth_values + interval) > gt)).float()


def _expand_mask(mask, prob_volume):
    if prob_volume.dim() == 5:  # (B, D, H, W, C)
        return mask[:, None, :, :, None].expand_as(prob_volume)
    return mask[:, None].expand_as(prob_volume)


def classification_loss(prob_volume, depth_values, interval, depth_gt, mask, weight):
    """BCE with pos_weight=(D-1) over the hypothesis axis."""
    d = depth_values.shape[1]
    gt_vol = _gt_index_volume(depth_values, depth_gt, interval, centered=True)
    if prob_volume.dim() == 5:
        gt_vol = gt_vol[..., None]
    ce = _bce_with_logits(prob_volume, gt_vol, pos_weight=float(d - 1)) * weight
    mask_e = _expand_mask(mask, ce)
    total = (ce * mask_e).sum()
    count = mask_e.sum()
    return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))


def gfocal_loss(prob_volume, depth_values, interval, depth_gt, mask, weight, gamma, alpha):
    """Generalized focal loss."""
    gt_vol = _gt_index_volume(depth_values, depth_gt, interval, centered=False)
    if prob_volume.dim() == 5:
        gt_vol = gt_vol[..., None]
    mask_e = _expand_mask(mask, prob_volume)
    pos_w = (gt_vol - prob_volume).abs() ** gamma * (gt_vol > 0)
    neg_w = alpha * prob_volume ** gamma * (gt_vol <= 0)
    focal = pos_w + neg_w
    p = prob_volume.clamp(1e-4, 1.0 - 1e-7)
    bce = -(gt_vol * torch.log(p) + (1 - gt_vol) * torch.log1p(-p))
    loss = (bce * focal * mask_e).sum() / mask_e.sum().clamp(min=1)
    return loss * weight


def unified_focal_loss(prob_volume, depth_values, interval, depth_gt, mask, weight,
                       gamma, alpha):
    """Unity-target focal loss."""
    gt_vol = _gt_index_volume(depth_values, depth_gt, interval, centered=False)
    unity = torch.where(gt_vol > 0, 1.0 - (depth_gt[:, None] - depth_values) / interval,
                        torch.zeros_like(gt_vol))
    if prob_volume.dim() == 5:
        unity = unity[..., None]
    mask_e = _expand_mask(mask, prob_volume)
    gt_unity = unity.amax(dim=1, keepdim=True)
    gt_unity = torch.where(gt_unity > 0, gt_unity, torch.ones_like(gt_unity))

    def sig5(x):
        return 1.0 / (1.0 + torch.exp(-x * math.log(5.0)))

    pos_w = (sig5((gt_unity - prob_volume).abs() / gt_unity) - 0.5) * 4 + 1
    neg_w = (sig5(prob_volume / gt_unity) - 0.5) * 2
    focal = pos_w ** gamma * (unity > 0) + alpha * neg_w ** gamma * (unity <= 0)
    p = prob_volume.clamp(1e-7, 1.0 - 1e-7)
    bce = -(unity * torch.log(p) + (1 - unity) * torch.log1p(-p))
    loss = (bce * focal * mask_e).sum() / mask_e.sum().clamp(min=1)
    return loss * weight


def entropy_loss(prob_volume, depth_gt, mask, depth_values):
    """Masked cross-entropy to the nearest-hypothesis one-hot.
    prob_volume: (B, D, H, W)."""
    idx = (depth_values - depth_gt[:, None]).abs().argmin(dim=1)  # (B, H, W)
    picked = torch.gather(prob_volume, 1, idx[:, None]).squeeze(1)
    ce = -torch.log(picked + 1e-6)
    valid = mask.sum(dim=(1, 2)) + 1e-6
    return ((ce * mask).sum(dim=(1, 2)) / valid).mean()


_FL_GAMMAS = (2.0, 1.0, 0.0)
_FL_ALPHAS = (0.75, 0.5, 0.25)


def alt_mvs_loss(outputs, depth_gt_ms, mask_ms, mode, dlossw):
    """Stage loop for the alternate modes."""
    total = 0.0
    for key in [k for k in outputs if k.startswith("stage")]:
        stage = outputs[key]
        idx = int(key.replace("stage", "")) - 1
        sw = float(dlossw[idx])
        gt = depth_gt_ms[key].float()
        mask = (mask_ms[key] > 0.5).float()
        args = (stage["prob_volume"], stage["depth_values"], stage["interval"], gt, mask, sw)
        if mode == "classification":
            total = total + classification_loss(*args)
        elif mode == "gfocal":
            total = total + gfocal_loss(*args, _FL_GAMMAS[idx], _FL_ALPHAS[idx])
        elif mode == "unification":
            total = total + unified_focal_loss(*args, _FL_GAMMAS[idx], _FL_ALPHAS[idx])
        else:
            raise NotImplementedError(
                f"mode must be regression/classification/gfocal/unification, got {mode}")
    return total
