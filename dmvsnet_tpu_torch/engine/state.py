"""Optimizer and LR schedule (port of dmvsnet_tpu.engine.state).

Adam(lr, weight_decay=0) with the schedule stepped once per optimizer
step at *fractional epochs* ``e = step / steps_per_epoch``:

steplr:   factor(e) = 1/3·(1-e/w) + e/w          for e < w  (warmup)
          factor(e) = decay^(#{milestones <= e})  otherwise
cosinelr: cosine from lr to decay^3·lr over the epochs after warmup.

The learning rate of optimizer step n is ``schedule(n)``: the schedule is
read before the step counter advances.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    scheduler: str = "steplr",
    warmup_epochs: float = 0.2,
    milestones: Sequence[float] = (10, 12, 14),
    lr_decay: float = 0.5,
    total_epochs: int = 16,
) -> Callable[[int], float]:
    """step (int) -> learning rate (float)."""
    if scheduler not in ("steplr", "cosinelr"):
        raise ValueError(f"unknown scheduler {scheduler}")
    milestones = tuple(float(m) for m in milestones)

    def schedule(step: int) -> float:
        e = step / steps_per_epoch
        if e < warmup_epochs:
            return base_lr * ((1.0 / 3.0) * (1.0 - e / warmup_epochs) + e / warmup_epochs)
        if scheduler == "steplr":
            return base_lr * lr_decay ** sum(m <= e for m in milestones)
        min_lr = base_lr * lr_decay ** 3
        t = (e - warmup_epochs) / (total_epochs - warmup_epochs)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(t * math.pi))

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter], lr_schedule: Callable[[int], float],
    weight_decay: float = 0.0,
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with torch-default betas (0.9, 0.999) and eps 1e-8 (AdamW when
    ``weight_decay`` is set), and a LambdaLR that sets the absolute learning
    rate ``lr_schedule(step)``.  Call ``optimizer.step()`` then
    ``scheduler.step()``; ``scheduler.last_epoch`` is the optimizer step."""
    if weight_decay:
        opt = torch.optim.AdamW(params, lr=1.0, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule)
