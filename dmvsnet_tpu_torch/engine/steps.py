"""Step factories (port of dmvsnet_tpu.engine.steps): depth-map inference.

Training and validation steps are later work (ROADMAP.md, open items).
"""

from __future__ import annotations

from typing import Callable

import torch


def make_infer_step() -> Callable:
    """Depth-map inference: (model, imgs, proj_matrices, depth_values) ->
    (depth (B, H, W), photometric_confidence (B, H, W)), run under
    ``torch.inference_mode()``."""

    def infer_step(model, imgs, proj_matrices, depth_values):
        with torch.inference_mode():
            outputs = model(imgs, proj_matrices, depth_values)
        return outputs["depth"], outputs["photometric_confidence"]

    return infer_step
