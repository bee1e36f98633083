"""The reference's training loss, learning rate and optimizer.

The loss is a frozen copy of the program's ``losses/mvs_loss.py``
(regression mode, one process, half-pixel Monte-Carlo centres) at commit
1e68102; the learning rate follows the ``steplr`` rule of
``engine/state.make_lr_schedule``; the optimizer is Adam (betas 0.9 /
0.999, eps 1e-8, no weight decay) written out in plain tensor arithmetic,
so that it shares no code with ``torch.optim``.
"""

from __future__ import annotations

import torch

from mvsbench.reference.model import checkerboard


def smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_ratio(total, count):
    return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))


def masked_weighted_mean(values, mask):
    return masked_ratio((values * mask).sum(), mask.sum())


def regression_loss(depth_est, depth_gt, mask, weight):
    return masked_weighted_mean(smooth_l1(depth_est, depth_gt) * weight, mask)


def half_pixel_pool(x):
    return 0.25 * (x[:, :-1, :-1] + x[:, :-1, 1:] + x[:, 1:, :-1] + x[:, 1:, 1:])


def monte_carlo_loss(depth_est, depth_gt, mask, weight):
    s_gt = half_pixel_pool(depth_gt)
    s_est = half_pixel_pool(depth_est)
    s_mask = (half_pixel_pool(mask.float()) >= 1.0).float()
    return regression_loss(s_est, s_gt, s_mask, half_pixel_pool(weight))


def _pass_loss(depth4, depth_gt, mask, stage_weight):
    w_map = torch.full_like(depth_gt, stage_weight)
    gt4, mask4 = depth_gt[..., None], mask[..., None]
    small, huge = depth4[..., :2], depth4[..., 2:]
    loss_depth = 2.0 * regression_loss(
        small, gt4.expand_as(small), mask4.expand_as(small), stage_weight,
    ) + 2.0 * regression_loss(
        huge, gt4.expand_as(huge), mask4.expand_as(huge), stage_weight,
    )

    def var_loss(a, b):
        var_gt = torch.maximum((a - depth_gt).abs(), (b - depth_gt).abs())
        return regression_loss((a - b).abs(), var_gt, mask, w_map)

    loss_var = var_loss(depth4[..., 0], depth4[..., 1]) + var_loss(
        depth4[..., 2], depth4[..., 3])
    cb = checkerboard(*depth_gt.shape[-2:], device=depth_gt.device)[None]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)
    loss_mc = (monte_carlo_loss(torch.where(cb, s_min, s_max), depth_gt, mask, w_map)
               + monte_carlo_loss(torch.where(~cb, s_min, s_max), depth_gt, mask, w_map)
               + monte_carlo_loss(torch.where(cb, h_min, h_max), depth_gt, mask, w_map)
               + monte_carlo_loss(torch.where(~cb, h_min, h_max), depth_gt, mask, w_map))
    return loss_depth + loss_var + loss_mc


def mvs_loss(outputs: dict, depth_gt_ms: dict, mask_ms: dict, dlossw) -> torch.Tensor:
    """The dual-depth loss over stages and passes."""
    total = 0.0
    for key in [k for k in outputs if k.startswith("stage")]:
        stage = outputs[key]
        sw = float(dlossw[int(key.replace("stage", "")) - 1])
        gt = depth_gt_ms[key].float()
        mask = (mask_ms[key] > 0.5).float()
        total = total + _pass_loss(stage["depth_sub_plus"], gt, mask, sw)
        total = total + _pass_loss(stage["depth_sub_plus_refine"], gt, mask, sw)
    return total


def steplr(step: int, base_lr: float, steps_per_epoch: int, warmup: float,
           milestones, decay: float) -> float:
    """The learning rate of optimizer step ``step`` (0-based) under the
    ``steplr`` schedule at fractional epochs."""
    e = step / steps_per_epoch
    if e < warmup:
        return base_lr * ((1.0 / 3.0) * (1.0 - e / warmup) + e / warmup)
    return base_lr * decay ** sum(m <= e for m in milestones)


class Adam:
    """Adam on a list of tensors: m, v, bias corrections as in Kingma & Ba."""

    def __init__(self, params: list[torch.Tensor], beta1=0.9, beta2=0.999, eps=1e-8):
        self.params = params
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.beta1 ** self.t
        c2 = 1.0 - self.beta2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad
            m.mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            denom = (v / c2).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)

