"""Configuration: a copy of dmvsnet_tpu.config (the reference's argparse
flags as one dataclass, plus the launcher recipes as named presets).

Port differences: ``warp_impl`` takes ``auto | cuda | torch`` (``auto`` =
the hand-written CUDA kernel on a CUDA device, its plain PyTorch version
on the CPU), and this slice runs fp32 throughout, so ``auto`` means
float32 for ``costreg_dtype`` and ``feature_dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence


@dataclass
class Config:
    # network
    fea_mode: str = "fpn"
    agg_mode: str = "variance"
    depth_mode: str = "regression"
    ndepths: Sequence[int] = (48, 32, 8)
    interval_ratio: Sequence[float] = (4.0, 2.0, 1.0)
    inverse_depth: bool = False
    compute_dtype: str = "float32"
    warp_impl: str = "auto"  # auto | cuda | torch
    costreg_dtype: str = "auto"  # auto (= float32) | float32
    feature_dtype: str = "auto"  # auto (= float32) | float32
    remat: bool = False

    # dataset
    datapath: str = ""
    trainlist: str = "train"
    testlist: str = "test"
    dataset_name: str = "dtu_yao"
    batch_size: int = 1
    numdepth: int = 192
    interval_scale: float = 1.06
    nviews: int = 5
    img_size: Sequence[int] = (512, 640)

    # training
    start_epoch: int = 0
    epochs: int = 16
    lr: float = 1e-3
    wd: float = 0.0
    scheduler: str = "steplr"
    warmup: float = 0.2
    milestones: Sequence[float] = (10, 12, 14)
    lr_decay: float = 0.5
    resume: str = ""
    log_dir: str = "./checkpoints"
    dlossw: Sequence[float] = (0.5, 1.0, 2.0)
    eval_freq: int = 1
    summary_freq: int = 50
    seed: int = 0
    blendedmvs_finetune: bool = False
    max_train_samples: int = 0
    max_val_samples: int = 0

    # testing
    outdir: str = "./outputs"
    # run ONE scene: its directory path; datapath becomes the parent and
    # the scan list collapses to [basename]
    testpath_single_scene: str = ""
    num_view: int = 5
    max_h: int = 864
    max_w: int = 1152
    fix_res: bool = False
    num_worker: int = 4
    # reference views inferred per dispatch; the tail batch is padded by
    # repetition so every dispatch of a scene has one shape
    eval_batch: int = 1
    filter_method: str = "pcd"
    conf: Sequence[float] = (0.1, 0.15, 0.7)
    thres_view: int = 5
    dist_base: float = 0.25
    rel_diff_base: float = 1.0 / 1300

    # parallelism
    mesh_data: int = 0
    mesh_spatial: int = 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# The four launcher recipes as presets.
PRESETS: dict[str, dict] = {
    "dtu_train": dict(
        dataset_name="dtu_yao", ndepths=(48, 32, 8), interval_ratio=(4, 2, 1),
        img_size=(512, 640), nviews=5, dlossw=(0.5, 1.0, 2.0), epochs=16,
        batch_size=2, lr=1e-3, warmup=0.2, scheduler="steplr",
        milestones=(10, 12, 14), lr_decay=0.5, trainlist="train",
        testlist="test", inverse_depth=True, numdepth=192, interval_scale=1.06,
    ),
    "dtu_test": dict(
        dataset_name="general_eval", ndepths=(48, 32, 8), interval_ratio=(4, 2, 1),
        max_h=864, max_w=1152, num_view=5, batch_size=1, testlist="test",
        numdepth=192, interval_scale=1.06, filter_method="pcd", thres_view=5,
        num_worker=1, inverse_depth=True, conf=(0.0, 0.0, 0.3),
        eval_batch=2,
    ),
    "tank_test": dict(
        dataset_name="general_eval", ndepths=(64, 32, 8), interval_ratio=(3, 2, 1),
        num_view=11, batch_size=1, testlist="all", numdepth=192,
        interval_scale=1.06, filter_method="dypcd",
    ),
    "blendedmvs_finetune": dict(
        dataset_name="blendedmvs", ndepths=(48, 32, 8), interval_ratio=(4, 2, 1),
        img_size=(576, 768), dlossw=(0.5, 1.0, 2.0), nviews=7, epochs=10,
        batch_size=1, lr=1e-4, scheduler="steplr", warmup=0.2, milestones=(6, 8),
        lr_decay=0.5, numdepth=128, interval_scale=1.06, blendedmvs_finetune=True,
    ),
}


def preset(name: str, **overrides) -> Config:
    cfg = Config(**PRESETS[name])
    return cfg.replace(**overrides) if overrides else cfg
