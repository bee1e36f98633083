"""Training orchestration (port of dmvsnet_tpu.engine.train), on one device.

Per epoch: reshuffle (set_epoch), iterate batches, one train step per
batch, tensorboard scalars/images where tensorboardX is installed, one
checkpoint per epoch, validation every eval_freq epochs.  Runs on CUDA
unless the caller asks for the CPU.  Data parallelism is later work.
"""

from __future__ import annotations

import os
import time
from typing import Any

import torch

from dmvsnet_tpu_torch import pin_fp32, resolve_device
from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.data.loader import get_dataset, make_loader
from dmvsnet_tpu_torch.data.splits import resolve_scan_list
from dmvsnet_tpu_torch.engine import checkpoint as ckpt_lib
from dmvsnet_tpu_torch.engine import imagery
from dmvsnet_tpu_torch.engine.state import make_lr_schedule, make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_eval_step, make_train_step
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights


class AverageMeter:
    """Running means of a scalar dict.

    Accumulates device scalars WITHOUT fetching them: each ``+`` is an
    asynchronous device op, so the train loop never blocks on a
    device-to-host copy per step.  ``avg`` is the only point that syncs.
    """

    def __init__(self):
        self.sums: dict[str, Any] = {}
        self.count = 0

    def update(self, scalars: dict[str, Any]):
        self.count += 1
        for k, v in scalars.items():
            self.sums[k] = v if k not in self.sums else self.sums[k] + v

    @property
    def avg(self) -> dict[str, float]:
        return {k: float(v) / max(self.count, 1) for k, v in self.sums.items()}


def build_model(cfg: Config, device: torch.device) -> MVSNet:
    """The MVSNet of ``cfg`` on ``device`` with a seeded random init from
    ``cfg.seed`` (the same seed gives the same weights on every device), in
    train mode.  Raises for what the port does not run yet."""
    if cfg.fea_mode != "fpn":
        raise NotImplementedError(f"fea_mode={cfg.fea_mode!r}: only 'fpn' is implemented")
    if cfg.agg_mode != "variance":
        raise NotImplementedError(
            f"agg_mode={cfg.agg_mode!r}: adaptive aggregation is not ported yet "
            "(ROADMAP.md, open items §1: adaptive aggregation)")
    for name in ("compute_dtype", "costreg_dtype", "feature_dtype"):
        if getattr(cfg, name) not in ("auto", "float32"):
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r}: the port runs fp32 only "
                "(ROADMAP.md, open items §1: bf16 policies)")
    if cfg.remat:
        raise NotImplementedError(
            "remat=True is not ported yet (ROADMAP.md, open items §1: "
            "rematerialisation with torch.utils.checkpoint)")
    impl = cfg.warp_impl
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "torch"
    elif impl == "epipolar":
        raise NotImplementedError(
            "warp_impl='epipolar' is not ported yet (ROADMAP.md, open items §1: "
            "kernels 4+5 with epipolar routing)")
    elif impl == "cuda" and device.type != "cuda":
        raise ValueError("warp_impl='cuda' needs a CUDA device")
    elif impl not in ("cuda", "torch"):
        raise ValueError(f"warp_impl must be auto, cuda or torch, got {impl!r}")

    # build without allocating, then fill every tensor from one seeded
    # CPU generator: the same seed gives the same weights on every device
    with torch.device("meta"):
        model = MVSNet(ndepths=tuple(cfg.ndepths),
                       depth_interval_ratio=tuple(cfg.interval_ratio),
                       inverse_depth=cfg.inverse_depth, warp_impl=impl)
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).train()


class Trainer:
    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # cuDNN defaults fp32 convolutions to TF32; the port is held to the
        # fp32 reference
        pin_fp32()
        self.model = build_model(cfg, self.device)

        train_scans = resolve_scan_list(cfg.trainlist, cfg.datapath)
        val_scans = resolve_scan_list(cfg.testlist, cfg.datapath)
        ds_kwargs = dict(ndepths=cfg.numdepth, interval_scale=cfg.interval_scale)
        if cfg.dataset_name == "dtu_yao":
            ds_kwargs["img_size"] = tuple(cfg.img_size)
        self.train_ds = get_dataset(
            cfg.dataset_name, cfg.datapath, train_scans, cfg.nviews, "train", **ds_kwargs)
        self.val_ds = get_dataset(
            cfg.dataset_name, cfg.datapath, val_scans, 5, "val", **ds_kwargs)
        if cfg.max_train_samples:
            self.train_ds.metas = self.train_ds.metas[: cfg.max_train_samples]
        if cfg.max_val_samples:
            self.val_ds.metas = self.val_ds.metas[: cfg.max_val_samples]
        self.train_loader = make_loader(self.train_ds, cfg.batch_size, "train", seed=cfg.seed)
        self.val_loader = make_loader(self.val_ds, cfg.batch_size, "val", seed=cfg.seed)

        steps_per_epoch = max(1, len(self.train_loader))
        self.lr_schedule = make_lr_schedule(
            cfg.lr, steps_per_epoch, cfg.scheduler, cfg.warmup,
            cfg.milestones, cfg.lr_decay, cfg.epochs)
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), self.lr_schedule, cfg.wd)
        self.start_epoch = cfg.start_epoch
        if cfg.resume:
            weights_only = cfg.blendedmvs_finetune
            resumed_epoch = ckpt_lib.restore_checkpoint(
                cfg.resume, self.model, self.optimizer, self.scheduler,
                weights_only=weights_only)
            if not weights_only:
                self.start_epoch = resumed_epoch

        self.train_step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode)
        self.eval_step = make_eval_step(tuple(cfg.dlossw), cfg.depth_mode)

        self.writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            os.makedirs(cfg.log_dir, exist_ok=True)
            self.writer = SummaryWriter(log_dir=cfg.log_dir)

    @property
    def step(self) -> int:
        """Optimizer steps taken so far (restored on resume)."""
        return self.scheduler.last_epoch

    def _log(self, tag: str, scalars: dict, step: int):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(f"{tag}/{k}", float(v), step)

    def _log_images(self, tag: str, host_batch: dict, depth, conf, step: int):
        if self.writer is not None:
            imagery.log_images(
                self.writer, tag,
                imagery.training_images(host_batch, depth.cpu().numpy(), conf.cpu().numpy()),
                step)

    def train(self) -> list[dict]:
        """Runs ``cfg.epochs`` epochs from ``start_epoch``; returns one
        summary per epoch: {"epoch", "train_avg", "val_avg" (None where
        no validation ran), "checkpoint"}."""
        cfg = self.cfg
        history = []
        for epoch in range(self.start_epoch, self.start_epoch + cfg.epochs):
            self.train_loader.set_epoch(epoch)
            meter = AverageMeter()
            t0 = time.time()
            for i, host_batch in enumerate(self.train_loader):
                batch = self.to_device(host_batch)
                scalars, (depth, conf) = self.train_step(
                    self.model, self.optimizer, self.scheduler, batch)
                meter.update(scalars)  # device-side accumulation, no sync
                gstep = epoch * len(self.train_loader) + i
                if gstep % cfg.summary_freq == 0:
                    # the ONLY per-step device->host fetch happens here
                    scalars = {k: float(v) for k, v in scalars.items()}
                    self._log("train", scalars, gstep)
                    self._log_images("train", host_batch, depth, conf, gstep)
                    print(
                        f"epoch {epoch} [{i}/{len(self.train_loader)}] "
                        f"loss {scalars['loss']:.3f} "
                        f"th2 {scalars['thres2mm_error']:.3f} "
                        f"({(time.time() - t0) / (i + 1):.2f}s/it)",
                        flush=True,
                    )
            train_avg = meter.avg
            self._log("train_avg", train_avg, epoch)
            path = ckpt_lib.save_checkpoint(
                cfg.log_dir, epoch, self.model, self.optimizer, self.scheduler)
            val_avg = None
            if epoch % cfg.eval_freq == 0 or epoch == cfg.epochs - 1:
                val_avg = self.validate(epoch)
            history.append(dict(epoch=epoch, train_avg=train_avg, val_avg=val_avg,
                                checkpoint=path))
        return history

    def validate(self, epoch: int = 0) -> dict[str, float]:
        """Held-out eval: per-batch 'test' scalars + image panel at
        summary_freq, epoch-mean 'test_avg' scalars."""
        meter = AverageMeter()
        n_batches = max(1, len(self.val_loader))
        for i, host_batch in enumerate(self.val_loader):
            batch = self.to_device(host_batch)
            scalars, depth, conf = self.eval_step(self.model, batch)
            meter.update(scalars)  # device-side accumulation, no sync
            gstep = epoch * n_batches + i
            if gstep % self.cfg.summary_freq == 0:
                self._log("test", {k: float(v) for k, v in scalars.items()}, gstep)
                self._log_images("test", host_batch, depth, conf, gstep)
        avg = meter.avg
        self._log("test_avg", avg, epoch)
        print(f"validate epoch {epoch}: {avg}", flush=True)
        return avg

    def to_device(self, batch: dict) -> dict:
        """A loader batch (numpy) as tensors on the trainer's device."""
        def move(v):
            if isinstance(v, dict):
                return {k: move(x) for k, x in v.items()}
            return torch.from_numpy(v).to(self.device)

        return {k: move(v) for k, v in batch.items() if k != "filename"}
