"""Training orchestration (port of dmvsnet_tpu.engine.train).

Per epoch: reshuffle (set_epoch), iterate batches, one train step per
batch, tensorboard scalars/images where tensorboardX is installed, one
checkpoint per epoch, validation every eval_freq epochs.  Runs on CUDA
unless the caller asks for the CPU.

The Trainer trains on a (dp, sp) mesh over every rank of the process
group (``parallel.init_multihost``; one rank without one), as the JAX
Trainer trains on its (dp, sp) device mesh: ``cfg.mesh_spatial`` ranks
split the rows of each cost U-Net (models/mvsnet.py), the others form dp.
``cfg.batch_size`` is the global batch; each dp coordinate loads its
1/dp share (the sp ranks of one dp coordinate load the same samples),
batch norm and the loss reduce over the global batch, DDP averages the
gradients over every rank, and the logged scalars are global.  Only rank 0
prints progress, writes tensorboard and writes the checkpoint.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any

import torch
from torch.nn.parallel import DistributedDataParallel

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
from dmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from dmvsnet_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    make_mesh,
    rank_and_world,
    replicate_tree,
    shard_batch,
)
from dmvsnet_tpu_torch.utils.trace import span


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


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtypes(cfg: Config) -> dict[str, torch.dtype | None]:
    """``MVSNet``'s dtype arguments from ``cfg``, as the JAX package's
    ``build_model`` resolves them off a TPU: ``compute_dtype`` is the
    model's ``dtype`` ("auto" = float32); ``costreg_dtype`` and
    ``feature_dtype`` "bfloat16" set their nets to bf16, while "float32" and
    "auto" give None, which follows ``dtype``.  "auto" never picks bf16 in
    the port: the JAX package picks it at eval on a TPU from TPU
    measurements, and the card's are in ``PERF.md``."""
    for name in ("compute_dtype", "costreg_dtype", "feature_dtype"):
        if getattr(cfg, name) not in ("auto", *_DTYPES):
            raise ValueError(f"{name} must be auto, float32 or bfloat16, "
                             f"got {getattr(cfg, name)!r}")
    net = {"auto": None, "float32": None, "bfloat16": torch.bfloat16}
    return dict(dtype=_DTYPES.get(cfg.compute_dtype, torch.float32),
                costreg_dtype=net[cfg.costreg_dtype], feature_dtype=net[cfg.feature_dtype])


def build_model(cfg: Config, device: torch.device, mesh=None) -> torch.nn.Module:
    """The network of ``cfg.architecture`` on ``device`` with a seeded random
    init from ``cfg.seed`` (the same seed gives the same weights on every
    device), in train mode: ``"dmvsnet"``, ``MVSNet`` on ``mesh`` (a
    ``parallel.Mesh``) if given, with ``cfg``'s aggregation, dtypes
    (``resolve_dtypes``) and remat; ``"transmvsnet"``, ``TransMVSNet``
    (``agg_mode="pixelwise"``; no mesh, no remat) with ``cfg``'s dtypes.
    Raises for what the port does not run."""
    if cfg.architecture not in ("dmvsnet", "transmvsnet"):
        raise ValueError(f"architecture must be 'dmvsnet' or 'transmvsnet', got "
                         f"{cfg.architecture!r}")
    if cfg.fea_mode != "fpn":
        raise NotImplementedError(f"fea_mode={cfg.fea_mode!r}: only 'fpn' is implemented")
    # "auto" never means the epipolar sweep: it is an approximation, taken
    # only on request (on CPU tensors its wrappers run their plain versions)
    impl = cfg.warp_impl
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "torch"
    elif impl == "cuda" and device.type != "cuda":
        raise ValueError("warp_impl='cuda' needs a CUDA device")
    elif impl not in ("cuda", "epipolar", "torch"):
        raise ValueError(f"warp_impl must be auto, cuda, epipolar or torch, got {impl!r}")

    # build without allocating, then fill every tensor from one seeded
    # CPU generator: the same seed gives the same weights on every device
    with torch.device("meta"):
        if cfg.architecture == "transmvsnet":
            if cfg.agg_mode != "pixelwise":
                raise ValueError(f"architecture='transmvsnet' weights views pixel by pixel: "
                                 f"agg_mode must be 'pixelwise', got {cfg.agg_mode!r}")
            if mesh is not None or cfg.remat:
                raise ValueError("architecture='transmvsnet' runs on one process without "
                                 "remat")
            model = TransMVSNet(ndepths=tuple(cfg.ndepths),
                                depth_interval_ratio=tuple(cfg.interval_ratio), warp_impl=impl,
                                **resolve_dtypes(cfg))
        else:
            model = MVSNet(ndepths=tuple(cfg.ndepths),
                           depth_interval_ratio=tuple(cfg.interval_ratio),
                           inverse_depth=cfg.inverse_depth, warp_impl=impl, mesh=mesh,
                           agg_mode=cfg.agg_mode, remat=cfg.remat, **resolve_dtypes(cfg))
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).train()


def data_parallel(model: MVSNet):
    """The module a train step runs: ``model`` itself without a process
    group; under one, DDP over every rank, after rank 0's parameters and
    buffers reached them all.  Each rank keeps its own buffers
    (``broadcast_buffers=False``): the synced batch norm keeps their running
    statistics equal, and a fault there shows instead of being overwritten
    from rank 0.  Checkpoints are written from ``model``, not the wrapper."""
    if not torch.distributed.is_initialized():
        return model
    replicate_tree(model)
    return DistributedDataParallel(model, broadcast_buffers=False, init_sync=False)


def _spanned_fetches(loader):
    """The batches of ``loader``, each fetch inside the span ``train.load``
    (the wait of a data-starved run)."""
    batches = iter(loader)
    while True:
        with span("train.load"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


class Trainer:
    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        if cfg.architecture != "dmvsnet":
            raise NotImplementedError(f"architecture={cfg.architecture!r}: the port trains "
                                      "DMVSNet only (TransMVSNet runs inference)")
        self.cfg = cfg
        self.device = resolve_device(device)
        # cuDNN defaults fp32 convolutions to TF32; the port is held to the
        # fp32 reference
        pin_fp32()
        self.rank, world = rank_and_world()
        n_data = cfg.mesh_data or max(1, world // cfg.mesh_spatial)
        # the global batch must divide over the dp axis; shrink dp to the
        # largest compatible size rather than failing at the first step
        if cfg.batch_size % n_data:
            n_data = math.gcd(cfg.batch_size, n_data)
            print(f"note: dp mesh axis reduced to {n_data} "
                  f"(batch_size {cfg.batch_size} must divide over it)", flush=True)
        self.mesh = make_mesh(n_data, n_spatial=cfg.mesh_spatial, device=self.device)
        self.model = build_model(cfg, self.device, self.mesh)

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
        # cfg.batch_size is the global batch; each dp coordinate loads its
        # share, and the sp ranks of one dp coordinate load the same samples
        n_data = self.mesh.size(AXIS_DATA)
        shard = dict(num_hosts=n_data, host_id=self.mesh.coords[AXIS_DATA])
        self.train_loader = make_loader(
            self.train_ds, cfg.batch_size // n_data, "train", seed=cfg.seed, **shard)
        self.val_loader = make_loader(
            self.val_ds, cfg.batch_size // n_data, "val", seed=cfg.seed, **shard)

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
        self.net = data_parallel(self.model)

        self.train_step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode, self.mesh)
        self.eval_step = make_eval_step(tuple(cfg.dlossw), cfg.depth_mode, self.mesh)

        self.writer = None
        if self.rank == 0:
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
            for i, host_batch in enumerate(_spanned_fetches(self.train_loader)):
                batch = self.to_device(host_batch)
                scalars, (depth, conf) = self.train_step(
                    self.net, self.optimizer, self.scheduler, batch)
                meter.update(scalars)  # device-side accumulation, no sync
                gstep = epoch * len(self.train_loader) + i
                if gstep % cfg.summary_freq == 0:
                    # the ONLY per-step device->host fetch happens here
                    scalars = {k: float(v) for k, v in scalars.items()}
                    self._log("train", scalars, gstep)
                    self._log_images("train", host_batch, depth, conf, gstep)
                    self._print(
                        f"epoch {epoch} [{i}/{len(self.train_loader)}] "
                        f"loss {scalars['loss']:.3f} "
                        f"th2 {scalars['thres2mm_error']:.3f} "
                        f"({(time.time() - t0) / (i + 1):.2f}s/it)")
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
        self._print(f"validate epoch {epoch}: {avg}")
        return avg

    def _print(self, text: str) -> None:
        if self.rank == 0:
            print(text, flush=True)

    def to_device(self, batch: dict) -> dict:
        """A loader batch (numpy; this rank's share) as tensors on the
        trainer's device."""
        return shard_batch({k: v for k, v in batch.items() if k != "filename"}, self.mesh)
