"""The port's end-to-end geometry gate on the CPU: network depths -> pcd
fusion -> DTU evaluator, the protocol of tests/test_geometry_gate.py
through the torch model (chip_smoke.py's phase 11, ``geometry_gate``, which
runs it on the card at every smoke run).

Overfit the cascade for 80 steps of the port's train step on a synthetic
textured plane, run the CLI's --test with pcd fusion on it, and grade the
fused cloud with ``eval_scan`` against a 2 mm grid on the plane: more than
5000 points, mean accuracy / completeness / overall under 4 mm, median z
within 2 mm of the plane.  Marked slow, as the JAX gate is.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.mark.slow
def test_geometry_gate_overfit_fuse_eval_on_cpu(tmp_path):
    row, weights = chip_smoke.geometry_gate(torch.device("cpu"), str(tmp_path), num_worker=1)
    assert row["points"] > 5000 and row["overall_mm"] < 4.0, row
    assert abs(row["median_z_mm"] - chip_smoke.PLANE_Z) < 2.0, row
    assert os.path.exists(weights) and row["maps"] == chip_smoke.GATE_V
