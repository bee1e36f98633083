#!/usr/bin/env python
"""Run the DTU benchmark protocol on fused point clouds (no MATLAB), with the
PyTorch/CUDA port's copy of the evaluator; scripts/dtu_eval.py is the JAX
package's.

Usage: python scripts/torch_dtu_eval.py <outdir>/pcd <dtu_sampleset_root>
"""
import sys

from dmvsnet_tpu_torch.fusion.dtu_eval import evaluate_dtu

if __name__ == "__main__":
    evaluate_dtu(sys.argv[1], sys.argv[2])
