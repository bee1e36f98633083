"""``correct`` against its control and its faults, at 64x96 on the CPU,
each cell held to its own limits.  The harness's look for a card is
skipped; the rest of a run is driven as the benchmark drives it.

* the program as configured passes;
* the control, the program's own bf16 policy (``compute_dtype=bfloat16``),
  fails;
* each fault the cell can have, planted under the timed path
  (``mvsbench/faults.py``), fails.

The same readings at the cells' own sizes on the card come from
``python3 -m mvsbench.calibrate`` (PERF.md gives them with the limits).
"""

from __future__ import annotations

import pytest

from mvsbench import faults, harness

FAULTS = {"dtu_eval": ["altered", "half_batch"], "tank_eval": ["altered"],
          "dtu_train": ["altered", "half_batch", "unchanged"]}
SEED = 2_147_483_659  # above 2**31


def _run(bench, cell, options=None):
    root, folder = bench
    return harness.run(f"tiny_{cell}", SEED, 0.3, False, device="cpu", bench_dir=folder,
                       root=root, options=options, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_program_passes_and_its_bf16_control_fails(tiny_bench, cell):
    sound = _run(tiny_bench, cell)
    assert sound["correct"], sound["checks"]
    control = _run(tiny_bench, cell, {"compute_dtype": "bfloat16"})
    assert not control["correct"], control["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_a_fault_under_the_timed_path_fails(tiny_bench, cell, fault):
    with faults.planted(fault):
        result = _run(tiny_bench, cell)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0
