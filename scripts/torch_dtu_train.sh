#!/usr/bin/env bash
# DTU training recipe of the PyTorch/CUDA port (the reference's scripts/train.sh),
# on one CUDA device; scripts/dtu_train.sh is the JAX package's.
datapath="${DTU_TRAINING:-/data/dtu_training}"
log_dir="${LOG_DIR:-checkpoints/dmvsnet_tpu_torch}"
mkdir -p "$log_dir"

python -m dmvsnet_tpu_torch.cli \
    --preset dtu_train \
    --datapath "$datapath" \
    --log_dir "$log_dir" \
    "$@" | tee -a "$log_dir/log.txt"
