"""A configuration brings its own reference as new files: a configuration
in a temporary benchmark folder names the module ``reference/pairwise.py``
beside it (``"reference": "pairwise"``), and an ``infer`` and a ``train``
cell check and count through it with no other file changed.  The module
sub-classes ``reference.model.MVSNet`` and calls ``model.cost_pass`` once
per (reference, source) pair, summing in view order, which is the
variance program's arithmetic: the check passes, and the count records
V - 1 passes of V = 2 where the plain reference records one of V.  With its
correlations scaled by 1.01 the same module fails the check."""

from __future__ import annotations

import json

import pytest

from mvsbench import harness

SEED = 2_147_483_659
VIEWS = 3  # the tiny cells' views
PAIRWISE = '''
from mvsbench.reference import model

SCALE = {scale!r}


class PairwiseMVSNet(model.MVSNet):
    def cost_volume(self, stage, refine, feats, rel, depth):
        total = None
        for i in range(1, feats.shape[1]):
            corr = model.cost_pass(feats[:, [0, i]].contiguous(), rel[:, i - 1:i].contiguous(),
                                   depth) * SCALE
            total = corr if total is None else total + corr
        return total


def build(config, device):
    return model.build(config, device, PairwiseMVSNet)
'''


def _bench(tiny_bench, cell: str, scale: float):
    """The tiny cell ``cell`` on a configuration ``tiny_pairwise`` that
    names the pairwise reference; returns the new cell's name."""
    root, bench = tiny_bench
    (bench / "reference" / "pairwise.py").write_text(PAIRWISE.format(scale=scale))
    cfg = json.loads((bench / "configs" / "tiny_dmvsnet_dtu.json").read_text())
    (bench / "configs" / "tiny_pairwise.json").write_text(json.dumps({**cfg,
                                                                    "reference": "pairwise"}))
    w = json.loads((bench / "workloads" / f"tiny_{cell}.json").read_text())
    name = f"tiny_pairwise_{cell}"
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({**w, "config": "tiny_pairwise"}))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for m in doc["end_to_end"] + doc["per_layer"]:
        if f"tiny_{cell}" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return name


def _run(tiny_bench, name: str, traced: bool):
    root, bench = tiny_bench
    lines = []
    result = harness.run(name, SEED, 0.3, traced, device="cpu", bench_dir=bench, root=root,
                         log=lambda line, **k: lines.append(line))
    return result, json.loads(next(x for x in lines if x.startswith("info ")).split(" ", 1)[1])


@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train"])
def test_a_configurations_own_reference_checks_and_counts(tiny_bench, cell):
    plain, plain_info = _run(tiny_bench, f"tiny_{cell}", True)
    result, info = _run(tiny_bench, _bench(tiny_bench, cell, 1.0), True)
    assert plain["correct"] and result["correct"], (plain["checks"], result["checks"])
    passes = info["count"]["passes"]
    assert [p[1] for p in plain_info["count"]["passes"]] == [VIEWS] * 6
    assert [p[1] for p in passes] == [2] * (6 * (VIEWS - 1))
    # every pass's adjoints are counted in training, none at eval
    assert all(p[-1] for p in passes) == (cell == "dtu_train")
    assert not any(p[-1] for p in passes) == (cell == "dtu_eval")
    assert info["count"]["ops_per_unit"] != plain_info["count"]["ops_per_unit"]


@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train"])
def test_the_check_takes_the_configurations_reference(tiny_bench, cell):
    result, _ = _run(tiny_bench, _bench(tiny_bench, cell, 1.01), False)
    assert not result["correct"], result["checks"]
