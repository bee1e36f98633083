"""The system under test, as the benchmark reaches it: ``dmvsnet_tpu_torch``
from the checkout the benchmark runs in (never an installed copy), set up
as its CLI sets itself up, with its ``Config`` made from a configuration
file and a cell's workload file."""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def package():
    """``dmvsnet_tpu_torch``, imported from the checkout's root."""
    pkg = importlib.import_module("dmvsnet_tpu_torch")
    where = Path(pkg.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"dmvsnet_tpu_torch was imported from {where}, not from the "
                           f"checkout {ROOT}")
    return pkg


# the Config fields that config() sets from a configuration's and a
# workload's own keys; a configuration's "program" object may set none of them
MAPPED = ("fea_mode", "agg_mode", "depth_mode", "ndepths", "interval_ratio", "inverse_depth",
          "numdepth", "interval_scale", "dlossw", "compute_dtype", "batch_size", "seed",
          "num_view", "max_h", "max_w", "eval_batch", "filter_method", "nviews", "img_size",
          "lr", "wd", "scheduler", "warmup", "milestones", "lr_decay", "epochs")


def config(ctx):
    """The program's ``Config`` of the cell: the configuration's network and
    its stated precision (``ctx.options["compute_dtype"]`` replaces it for
    the control), the workload's sizes and training settings, then the
    configuration's ``"program"`` object verbatim, each key a field of the
    port's ``Config`` that ``MAPPED`` does not hold.  A key that the port's
    ``Config`` lacks, or that repeats a mapped field, is refused by name
    before anything is built."""
    from dmvsnet_tpu_torch.config import Config

    c, w = ctx.config, ctx.workload
    extra = c.get("program", {})
    unknown = sorted(set(extra) - {f.name for f in dataclasses.fields(Config)})
    if unknown:
        raise ValueError(f"the configuration's \"program\" names {unknown}, which the "
                         f"port's Config lacks")
    repeated = sorted(set(extra) & set(MAPPED))
    if repeated:
        raise ValueError(f"the configuration's \"program\" repeats {repeated}, which the "
                         f"benchmark sets from the configuration or the workload")
    fields = dict(
        fea_mode=c["fea_mode"], agg_mode=c["agg_mode"], depth_mode=c["depth_mode"],
        ndepths=tuple(c["ndepths"]), interval_ratio=tuple(c["interval_ratio"]),
        inverse_depth=c["inverse_depth"], numdepth=c["numdepth"],
        interval_scale=c["interval_scale"], dlossw=tuple(c["dlossw"]),
        compute_dtype=ctx.options.get("compute_dtype", c["precision"]),
        batch_size=w["batch"], seed=ctx.seed % (1 << 63))
    if w["mode"] == "infer":
        fields.update(num_view=w["views"], max_h=w["height"], max_w=w["width"],
                      eval_batch=w["batch"], filter_method="none")
    else:
        t = w["training"]
        fields.update(nviews=w["views"], img_size=(w["height"], w["width"]), lr=t["lr"],
                      wd=t["wd"], scheduler=t["scheduler"], warmup=t["warmup"],
                      milestones=tuple(t["milestones"]), lr_decay=t["lr_decay"],
                      epochs=t["epochs"])
    return Config(**fields, **extra)


def device(ctx):
    """The device as the CLI resolves it, with the CLI's fp32 pinning."""
    pkg = package()
    dev = pkg.resolve_device(ctx.device)
    pkg.pin_fp32()
    return dev
