"""Checkpoint save/restore (port of dmvsnet_tpu.engine.checkpoint).

One ``torch.save`` file per epoch, ``model_{epoch:06d}.ckpt``, holding
``{epoch, step, model, optimizer, lr_scheduler}`` with the model's state
dict in the reference naming (the port's own module layout), so
``tools/convert_torch_ckpt.py`` and ``convert.jax_tree_from_state_dict``
read it.  Two restore modes:

* full resume (training): weights + optimizer + scheduler + epoch;
* weights-only (val / test / finetune): weights only.
"""

from __future__ import annotations

import os

import torch

from dmvsnet_tpu_torch.convert import load_reference_state_dict


def _path(log_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(log_dir), f"model_{epoch:06d}.ckpt")


def save_checkpoint(log_dir: str, epoch: int, model, optimizer, scheduler) -> str:
    """Full-state save, one file per epoch; written to a temporary name and
    renamed, so a reader never sees half a file."""
    path = _path(log_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "epoch": epoch,
        "step": scheduler.last_epoch,
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "lr_scheduler": scheduler.state_dict(),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, model, optimizer=None, scheduler=None,
                       weights_only: bool = False) -> int:
    """Restore into existing objects; returns the epoch to continue from.

    ``weights_only`` restores the model alone and returns 0, as val / test
    / finetune do; otherwise optimizer and scheduler are restored too and
    the saved epoch + 1 is returned.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(model, payload["model"])
    if weights_only:
        return 0
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["lr_scheduler"])
    return int(payload["epoch"]) + 1


def save_weights(path: str, model) -> None:
    """Weights-only checkpoint: ``{"model": state_dict}``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": model.state_dict()}, path)


def restore_weights(path: str, model):
    """Restore a weights-only checkpoint (or the weights of a full one)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference_state_dict(model, payload.get("model", payload))


def latest_checkpoint(log_dir: str) -> str | None:
    if not os.path.isdir(log_dir):
        return None
    cands = sorted(f for f in os.listdir(log_dir)
                   if f.startswith("model_") and f.endswith(".ckpt"))
    return os.path.join(log_dir, cands[-1]) if cands else None
