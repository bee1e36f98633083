"""Step factories (port of dmvsnet_tpu.engine.steps): train, eval and
depth-map inference.  PyTorch runs eagerly, so a step is a plain function:
forward (2 passes x 3 stages), loss, backward, Adam update, metrics.

On a ``mesh`` (``parallel.make_mesh``) the loss and the metrics are those
of the global batch and the returned scalars are reduced over the dp group
before they are returned, so they are the same on every rank; the model of
a train step is then wrapped in DDP, which averages the gradients.
"""

from __future__ import annotations

from typing import Callable

import torch

from dmvsnet_tpu_torch.losses import metrics as metrics_lib
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.parallel.mesh import AXIS_DATA
from dmvsnet_tpu_torch.utils.trace import span


def _scalars(outputs, batch, loss, dlossw, mesh) -> dict[str, torch.Tensor]:
    final = f"stage{len(dlossw)}"
    gt = batch["depth"][final]
    mask = batch["mask"][final] > 0.5
    # each rank's loss is n_dp times its share of the global loss
    # (losses/mvs_loss.py), so the dp mean is the global loss
    loss = loss.detach() if mesh is None else mesh.mean(loss, AXIS_DATA)
    with torch.no_grad():
        return {"loss": loss,
                **metrics_lib.standard_metrics(outputs["depth"], gt, mask, mesh)}


def make_train_step(dlossw=(0.5, 1.0, 2.0), depth_mode: str = "regression",
                    mesh=None) -> Callable:
    """train_step(model, optimizer, scheduler, batch) -> (scalars, (depth,
    photometric_confidence)).

    Puts the model in train mode, runs forward, loss and backward, one
    optimizer step, then one scheduler step.  ``scalars`` holds loss, the
    standard metrics (device tensors) and the learning rate this step used;
    depth and confidence stay on the device too, so the host pays a copy
    only where it reads them.  The step is the span ``train.step``, each
    phase a span inside it (``utils/trace``).
    """

    def train_step(model, optimizer, scheduler, batch):
        with span("train.step"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            with span("train.loss"):
                loss = mvs_loss(outputs, batch["depth"], batch["mask"], depth_mode, dlossw, mesh)
            with span("train.backward"):
                loss.backward()
            with span("train.metrics"):
                scalars = _scalars(outputs, batch, loss, dlossw, mesh)
                scalars["lr"] = scheduler.get_last_lr()[0]
            with span("train.optimizer"):
                optimizer.step()
                scheduler.step()
            return scalars, (outputs["depth"].detach(), outputs["photometric_confidence"])

    return train_step


def make_eval_step(dlossw=(0.5, 1.0, 2.0), depth_mode: str = "regression",
                   mesh=None) -> Callable:
    """eval_step(model, batch) -> (scalars, depth, photometric_confidence),
    in eval mode under ``torch.no_grad()``."""

    def eval_step(model, batch):
        model.eval()
        with torch.no_grad():
            outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            loss = mvs_loss(outputs, batch["depth"], batch["mask"], depth_mode, dlossw, mesh)
        scalars = _scalars(outputs, batch, loss, dlossw, mesh)
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
