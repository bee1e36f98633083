"""Step factories (port of dmvsnet_tpu.engine.steps): train, eval and
depth-map inference.  PyTorch runs eagerly, so a step is a plain function:
forward (2 passes x 3 stages), loss, backward, Adam update, metrics.
"""

from __future__ import annotations

from typing import Callable

import torch

from dmvsnet_tpu_torch.losses import metrics as metrics_lib
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss


def _scalars(outputs, batch, loss, dlossw) -> dict[str, torch.Tensor]:
    final = f"stage{len(dlossw)}"
    gt = batch["depth"][final]
    mask = batch["mask"][final] > 0.5
    with torch.no_grad():
        return {"loss": loss.detach(),
                **metrics_lib.standard_metrics(outputs["depth"], gt, mask)}


def make_train_step(dlossw=(0.5, 1.0, 2.0), depth_mode: str = "regression") -> Callable:
    """train_step(model, optimizer, scheduler, batch) -> (scalars, (depth,
    photometric_confidence)).

    Puts the model in train mode, runs forward, loss and backward, one
    optimizer step, then one scheduler step.  ``scalars`` holds loss, the
    standard metrics (device tensors) and the learning rate this step used; depth and confidence stay on the device too, so the host pays
    a copy only where it reads them.
    """

    def train_step(model, optimizer, scheduler, batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss = mvs_loss(outputs, batch["depth"], batch["mask"], depth_mode, dlossw)
        loss.backward()
        scalars = _scalars(outputs, batch, loss, dlossw)
        scalars["lr"] = scheduler.get_last_lr()[0]
        optimizer.step()
        scheduler.step()
        return scalars, (outputs["depth"].detach(), outputs["photometric_confidence"])

    return train_step


def make_eval_step(dlossw=(0.5, 1.0, 2.0), depth_mode: str = "regression") -> Callable:
    """eval_step(model, batch) -> (scalars, depth, photometric_confidence),
    in eval mode under ``torch.no_grad()``."""

    def eval_step(model, batch):
        model.eval()
        with torch.no_grad():
            outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            loss = mvs_loss(outputs, batch["depth"], batch["mask"], depth_mode, dlossw)
        scalars = _scalars(outputs, batch, loss, dlossw)
        return scalars, outputs["depth"], outputs["photometric_confidence"]

    return eval_step


def make_infer_step() -> Callable:
    """Depth-map inference: (model, imgs, proj_matrices, depth_values) ->
    (depth (B, H, W), photometric_confidence (B, H, W)), run under
    ``torch.inference_mode()``."""

    def infer_step(model, imgs, proj_matrices, depth_values):
        with torch.inference_mode():
            outputs = model(imgs, proj_matrices, depth_values)
        return outputs["depth"], outputs["photometric_confidence"]

    return infer_step
