#!/usr/bin/env bash
# BlendedMVS finetune with the PyTorch/CUDA port (reference
# scripts/blendedmvs_finetune.sh): weights-only resume from a DTU checkpoint.
datapath="${BLENDEDMVS:-/data/blendedmvs/dataset_low_res}"
log_dir="${LOG_DIR:-checkpoints/dmvsnet_tpu_torch_finetune}"
resume="${RESUME:?set RESUME to the DTU checkpoint}"
mkdir -p "$log_dir"

python -m dmvsnet_tpu_torch.cli \
    --preset blendedmvs_finetune \
    --datapath "$datapath" \
    --log_dir "$log_dir" \
    --resume "$resume" \
    "$@" | tee -a "$log_dir/log.txt"
