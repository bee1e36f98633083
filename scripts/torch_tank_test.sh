#!/usr/bin/env bash
# Tanks & Temples inference + dypcd fusion with the PyTorch/CUDA port (reference
# scripts/tank_test.sh); scripts/tank_test.sh is the JAX package's.
datapath="${TANK_DATA:?set TANK_DATA to the T&T preprocessed inputs}"
outdir="${OUTDIR:-outputs_tank}"
resume="${RESUME:?set RESUME to a checkpoint path}"

python -m dmvsnet_tpu_torch.cli \
    --test --preset tank_test \
    --datapath "$datapath" \
    --outdir "$outdir" \
    --resume "$resume" \
    "$@"
