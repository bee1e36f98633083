"""Command-line entry point of the port: depth-map inference.

  dmvsnet-torch --test --preset dtu_test --datapath ... --filter_method none \\
      [--resume state_dict.pt] [--outdir ...] [--device cuda|cpu]

Runs on CUDA unless ``--device cpu``.  Training, fusion and visualisation
are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from dmvsnet_tpu_torch.config import PRESETS, Config, preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dmvsnet_tpu_torch")
    p.add_argument("--preset", choices=sorted(PRESETS))
    p.add_argument("--test", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    # network
    p.add_argument("--ndepths", type=int, nargs="+", default=None)
    p.add_argument("--interval_ratio", type=float, nargs="+", default=None)
    p.add_argument("--inverse_depth", action="store_true", default=None)
    p.add_argument("--warp_impl", default=None, choices=["auto", "cuda", "torch"])

    # dataset
    p.add_argument("--datapath", default=None)
    p.add_argument("--testlist", default=None)
    p.add_argument("--numdepth", type=int, default=None)
    p.add_argument("--interval_scale", type=float, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=None)

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
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.test:
        parser.error("only --test (depth inference) is ported so far")
    from dmvsnet_tpu_torch.engine.evaluate import run_test

    return run_test(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
