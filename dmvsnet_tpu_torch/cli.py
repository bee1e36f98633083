"""Command-line entry point of the port: training, validation and
depth-map inference.

  dmvsnet-torch --preset dtu_train --datapath ... --log_dir ... [--resume model_000003.ckpt]
  dmvsnet-torch --val --preset dtu_train --datapath ... --resume ...
  dmvsnet-torch --test --preset dtu_test --datapath ... --filter_method none \\
      [--resume state_dict.pt] [--outdir ...]

Runs on CUDA unless ``--device cpu``.  The flags are those of the JAX
package's CLI without its mesh and platform flags; fusion, ``--vis`` and
the blendedmvs dataset are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from dmvsnet_tpu_torch.config import PRESETS, Config, preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dmvsnet_tpu_torch")
    p.add_argument("--preset", choices=sorted(PRESETS))
    # modes: training unless one of these is given
    p.add_argument("--val", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--vis", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    # network
    p.add_argument("--fea_mode", default=None, choices=["fpn", "unet", "hrnet"])
    p.add_argument("--agg_mode", default=None, choices=["variance", "adaptive"])
    p.add_argument("--depth_mode", default=None,
                   choices=["regression", "classification", "unification", "gfocal"])
    p.add_argument("--ndepths", type=int, nargs="+", default=None)
    p.add_argument("--interval_ratio", type=float, nargs="+", default=None)
    p.add_argument("--inverse_depth", action="store_true", default=None)
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--warp_impl", default=None, choices=["auto", "cuda", "epipolar", "torch"],
                   help="cost pass: auto = the exact CUDA kernel on the card (plain torch on "
                        "the CPU); epipolar = the rectified 1-D sweep, an eval-time "
                        "approximation gated by NUMERICS.json tol.epi_*")
    p.add_argument("--costreg_dtype", default=None, choices=["auto", "float32", "bfloat16"])
    p.add_argument("--feature_dtype", default=None, choices=["auto", "float32", "bfloat16"])
    p.add_argument("--remat", action="store_true", default=None)

    # dataset
    p.add_argument("--datapath", default=None)
    p.add_argument("--trainlist", default=None)
    p.add_argument("--testlist", default=None)
    p.add_argument("--dataset_name", default=None,
                   choices=["dtu_yao", "general_eval", "blendedmvs"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--numdepth", type=int, default=None)
    p.add_argument("--interval_scale", type=float, default=None)
    p.add_argument("--nviews", type=int, default=None)
    p.add_argument("--img_size", type=int, nargs="+", default=None)

    # training
    p.add_argument("--start_epoch", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--scheduler", default=None, choices=["steplr", "cosinelr"])
    p.add_argument("--warmup", type=float, default=None)
    p.add_argument("--milestones", type=float, nargs="+", default=None)
    p.add_argument("--lr_decay", type=float, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--dlossw", type=float, nargs="+", default=None)
    p.add_argument("--eval_freq", type=int, default=None)
    p.add_argument("--summary_freq", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--blendedmvs_finetune", action="store_true", default=None)
    p.add_argument("--max_train_samples", type=int, default=None,
                   help="cap the training metas (0 = all)")
    p.add_argument("--max_val_samples", type=int, default=None,
                   help="cap the validation metas (0 = all)")

    # testing
    p.add_argument("--outdir", default=None)
    p.add_argument("--testpath_single_scene", default=None)
    p.add_argument("--num_view", type=int, default=None)
    p.add_argument("--max_h", type=int, default=None)
    p.add_argument("--max_w", type=int, default=None)
    p.add_argument("--fix_res", action="store_true", default=None)
    p.add_argument("--eval_batch", type=int, default=None,
                   help="reference views inferred per dispatch")
    p.add_argument("--filter_method", default=None, choices=["pcd", "dypcd", "none"])
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = preset(args.preset) if args.preset else Config()
    field_names = {f.name for f in dataclasses.fields(Config)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in field_names and v is not None}
    return cfg.replace(**overrides)


def main(argv=None) -> dict:
    """Runs the chosen mode and returns its summary: run_test's dict for
    ``--test``; {"mode", "device", "step", "history" | "val_avg"} for
    training and ``--val``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.vis:
        parser.error("--vis is not ported yet (ROADMAP.md, open items §1: CLI presets)")
    cfg = config_from_args(args)
    if args.test:
        from dmvsnet_tpu_torch.engine.evaluate import run_test

        return run_test(cfg, device=args.device)

    from dmvsnet_tpu_torch.engine.train import Trainer

    trainer = Trainer(cfg, device=args.device)
    summary = {"mode": "val" if args.val else "train", "device": str(trainer.device)}
    if args.val:
        summary["val_avg"] = trainer.validate()
    else:
        summary["history"] = trainer.train()
    summary["step"] = trainer.step
    return summary


if __name__ == "__main__":
    main()
