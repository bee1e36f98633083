"""Tensorboard image panels (a copy of dmvsnet_tpu.engine.imagery).

Builds the reference trainer's visual-regression imagery from a batch +
model outputs: masked/unmasked depth, GT, clipped error map, confidence
map + its 0.1/0.5/0.9 threshold masks, and the ``up_dn`` panel — yellow
where the prediction overshoots GT, green where it undershoots, masked
to |err| < 2 — which visualizes the saddle-cell up/down oscillation.
All numpy, HWC float in [0, 1] (or scalar-range maps normalized by the
writer).
"""

from __future__ import annotations

import numpy as np


def _norm(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo + 1e-8)


def up_down_panel(depth_est: np.ndarray, depth_gt: np.ndarray,
                  mask: np.ndarray) -> np.ndarray:
    """(H, W, 3): yellow = est > gt, green = est < gt, black elsewhere."""
    h, w = depth_est.shape
    yellow = np.array([1.0, 1.0, 0.0], np.float32)
    green = np.array([0.0, 1.0, 0.0], np.float32)
    panel = np.where((depth_est > depth_gt)[..., None], green, yellow)
    keep = (mask > 0) & (np.abs(depth_est - depth_gt) < 2)
    return panel * keep[..., None]


def training_images(batch: dict, depth_est: np.ndarray, confidence: np.ndarray,
                    final_stage: str = "stage3") -> dict[str, np.ndarray]:
    """First-sample image dict matching the reference's tensorboard keys."""
    gt = np.asarray(batch["depth"][final_stage])[0]
    mask = np.asarray(batch["mask"][final_stage])[0]
    est = np.asarray(depth_est)[0]
    conf = np.asarray(confidence)[0]
    ref_img = np.asarray(batch["imgs"])[0, 0]
    return {
        "depth_est": _norm(est * mask),
        "depth_est_nomask": _norm(est),
        "depth_gt": _norm(gt),
        "ref_img": ref_img,
        "mask": mask,
        "conf": conf,
        "conf_09mask": (conf > 0.9).astype(np.float32),
        "conf_05mask": (conf > 0.5).astype(np.float32),
        "conf_01mask": (conf > 0.1).astype(np.float32),
        "errormap": _norm(np.clip(np.abs(est - gt), 0, 2) * mask),
        "up_dn": up_down_panel(est, gt, mask),
    }


def log_images(writer, tag: str, images: dict[str, np.ndarray], step: int) -> None:
    if writer is None:
        return
    for k, img in images.items():
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        writer.add_image(f"{tag}/{k}", np.clip(img, 0, 1), step, dataformats="HWC")
