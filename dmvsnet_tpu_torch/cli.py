"""Command-line entry point of the port: training, validation, depth-map
inference with point-cloud fusion, and depth-map visualisation.

  dmvsnet-torch --preset dtu_train --datapath ... --log_dir ... [--resume model_000003.ckpt]
  dmvsnet-torch --val --preset dtu_train --datapath ... --resume ...
  dmvsnet-torch --test --preset dtu_test --datapath ... [--resume state_dict.pt] [--outdir ...]
  dmvsnet-torch --test --preset tank_test --datapath ... --resume ...
  dmvsnet-torch --preset blendedmvs_finetune --datapath ... --resume model_000015.ckpt
  dmvsnet-torch --vis --depth_path out.pfm [--depth_img_save_dir DIR]
  torchrun --nproc_per_node N -m dmvsnet_tpu_torch.cli --preset dtu_train ...

Runs on CUDA unless ``--device cpu`` (``--vis`` needs no device).  The
flags are those of the JAX package's CLI without its platform flag.  Under
``torchrun`` (or the JAX package's COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID) training and ``--val`` run data-parallel over every rank (nccl
on CUDA, gloo on the CPU; ``--mesh_data`` and ``--mesh_spatial`` as in the
JAX package: ``--mesh_spatial S`` splits the rows of every cost U-Net over
S ranks);
``--test`` runs in one process, as the JAX package's does.
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
    p.add_argument("--architecture", default=None, choices=["dmvsnet", "transmvsnet"],
                   help="the network: DMVSNet, or TransMVSNet (inference; it weights "
                        "views pixel by pixel, agg_mode pixelwise)")
    p.add_argument("--fea_mode", default=None, choices=["fpn", "unet", "hrnet"])
    p.add_argument("--agg_mode", default=None, choices=["variance", "adaptive"],
                   help="DMVSNet's view aggregation")
    p.add_argument("--depth_mode", default=None,
                   choices=["regression", "classification", "unification", "gfocal"])
    p.add_argument("--ndepths", type=int, nargs="+", default=None)
    p.add_argument("--interval_ratio", type=float, nargs="+", default=None)
    p.add_argument("--inverse_depth", action="store_true", default=None)
    p.add_argument("--compute_dtype", default=None, choices=["auto", "float32", "bfloat16"],
                   help="dtype the features are cast to and the default of the two below "
                        "(auto = float32); the cost passes run fp32 either way")
    p.add_argument("--warp_impl", default=None, choices=["auto", "cuda", "epipolar", "torch"],
                   help="cost pass: auto = the exact CUDA kernel on the card (plain torch on "
                        "the CPU); epipolar = the rectified 1-D sweep, an eval-time "
                        "approximation gated by NUMERICS.json tol.epi_*")
    p.add_argument("--costreg_dtype", default=None, choices=["auto", "float32", "bfloat16"],
                   help="cost U-Nets' compute dtype (auto, float32: as --compute_dtype)")
    p.add_argument("--feature_dtype", default=None, choices=["auto", "float32", "bfloat16"],
                   help="feature net's compute dtype (auto, float32: as --compute_dtype)")
    p.add_argument("--remat", action="store_true", default=None,
                   help="training: recompute the feature net, cost U-Nets and cost passes "
                        "in the backward")

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
    p.add_argument("--num_worker", type=int, default=None,
                   help="fusion worker processes (pcd)")
    p.add_argument("--filter_method", default=None, choices=["pcd", "dypcd", "none"])
    p.add_argument("--conf", type=float, nargs="+", default=None)
    p.add_argument("--thres_view", type=int, default=None)
    p.add_argument("--dist_base", type=float, default=None)
    p.add_argument("--rel_diff_base", type=float, default=None)

    # visualization
    p.add_argument("--depth_path", default=None)
    p.add_argument("--depth_img_save_dir", default=".")

    # mesh
    p.add_argument("--mesh_data", type=int, default=None,
                   help="ranks on the data axis (default: all); reduced to divide batch_size")
    p.add_argument("--mesh_spatial", type=int, default=None,
                   help="ranks on the spatial axis: each splits the rows of the cost "
                        "U-Nets (default 1)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = preset(args.preset) if args.preset else Config()
    field_names = {f.name for f in dataclasses.fields(Config)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in field_names and v is not None}
    if overrides.get("architecture") == "transmvsnet":
        overrides.setdefault("agg_mode", "pixelwise")
    return cfg.replace(**overrides)


def main(argv=None) -> dict:
    """Runs the chosen mode and returns its summary: run_test's dict for
    ``--test``; {"mode", "device", "step", "history" | "val_avg"} for
    training and ``--val``; {"mode": "vis", "png": path} for ``--vis``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.vis:
        if not args.depth_path:
            parser.error("--vis needs --depth_path")
        from dmvsnet_tpu_torch.engine.evaluate import run_visualization

        out = run_visualization(args.depth_path, args.depth_img_save_dir)
        print(f"saved {out}")
        return {"mode": "vis", "png": out}
    cfg = config_from_args(args)
    if args.test:
        from dmvsnet_tpu_torch.engine.evaluate import run_test
        from dmvsnet_tpu_torch.parallel.mesh import rank_and_world

        rank_and_world()  # raises under WORLD_SIZE > 1: run_test is one process
        return run_test(cfg, device=args.device)

    from dmvsnet_tpu_torch.engine.train import Trainer
    from dmvsnet_tpu_torch.parallel import init_multihost

    init_multihost(args.device)

    trainer = Trainer(cfg, device=args.device)
    summary = {"mode": "val" if args.val else "train", "device": str(trainer.device)}
    if args.val:
        summary["val_avg"] = trainer.validate()
    else:
        summary["history"] = trainer.train()
    summary["step"] = trainer.step
    return summary


def console_main() -> None:
    """The ``dmvsnet-torch`` console script and ``python -m``: ``main``
    without its return value, which the console script would pass to
    ``sys.exit`` (a dict there prints itself and exits 1); then the process
    group, if the run made one, is taken down."""
    import torch.distributed as dist

    main()
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    console_main()
