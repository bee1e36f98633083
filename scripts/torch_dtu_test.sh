#!/usr/bin/env bash
# DTU depth inference + pcd fusion with the PyTorch/CUDA port (the reference's
# scripts/dtu_test.sh); scripts/dtu_test.sh is the JAX package's.
datapath="${DTU_EVAL:-/data/dtu_eval}"
outdir="${OUTDIR:-outputs_dtu}"
resume="${RESUME:?set RESUME to a checkpoint path}"

python -m dmvsnet_tpu_torch.cli \
    --test --preset dtu_test \
    --datapath "$datapath" \
    --outdir "$outdir" \
    --resume "$resume" \
    "$@"
