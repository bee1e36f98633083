"""A configuration of another architecture gets through the harness with new
files only.  In a temporary benchmark folder a configuration names a
``"program"`` field and a reference module of its own,
``reference/linear_cascade.py``: a cascade whose feature path is a linear
embedding, a layer norm, a Conv1d + BatchNorm1d position encoding and a
linear merge, whose cost regularisation is one 3-D convolution a stage, and
which has no refine U-Nets.  The program's side is the same model, from a
monkeypatch of ``engine.evaluate.build_model`` in this test alone.  A tiny
``infer`` cell runs set-up (seeded weights), the window, the traced
sub-window's spans, the count and the check, and passes; with the
reference's layer-norm output scaled by 1.01 the check fails."""

from __future__ import annotations

import json

import pytest
import torch

from dmvsnet_tpu_torch.engine import evaluate
from mvsbench import harness

SEED = 2_147_484_013
VIEWS = 3  # the tiny cells' views
REFERENCE = '''
import torch
import torch.nn.functional as F
from torch import nn

from mvsbench.reference import model

SCALE = {scale!r}


class Features(nn.Module):
    """(N, H, W, 3) images -> (N, H, W, C) features."""

    def __init__(self, c, scale):
        super().__init__()
        self.scale = scale
        self.embed = nn.Linear(3, c)
        self.norm = nn.LayerNorm(c)
        self.pos = nn.Sequential(nn.Conv1d(2, c, 1), nn.BatchNorm1d(c))
        self.merge = nn.Linear(c, c, bias=False)

    def forward(self, x):
        n, h, w, _ = x.shape
        ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                                torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
        grid = torch.stack([xs, ys]).reshape(1, 2, h * w).expand(n, 2, h * w)
        pos = self.pos(grid).transpose(1, 2).reshape(n, h, w, -1)
        return self.merge(self.norm(self.embed(x)) * self.scale + pos)


class LinearCascade(nn.Module):
    def __init__(self, ndepths, interval_ratio, inverse_depth, scale=1.0, c=8):
        super().__init__()
        self.ndepths, self.interval_ratio = tuple(ndepths), tuple(interval_ratio)
        self.inverse_depth = inverse_depth
        self.feature = Features(c, scale)
        self.cost_regularization = nn.ModuleList(
            [nn.Conv3d(2, 1, 3, padding=1) for _ in self.ndepths])

    def forward(self, imgs, proj_matrices, depth_values):
        b, v, h, w, _ = imgs.shape
        n = len(self.ndepths)
        feats = self.feature(imgs.float().reshape(b * v, h, w, 3)).permute(0, 3, 1, 2)
        step = (depth_values[0, -1] - depth_values[0, 0]) / depth_values.shape[1]
        out, depth = {{}}, None
        for s in range(n):
            k = 2 ** (n - s - 1)
            f = F.avg_pool2d(feats, k) if k > 1 else feats
            f = f.reshape(b, v, *f.shape[1:]).permute(0, 1, 3, 4, 2).contiguous()
            sh, sw = f.shape[2:4]
            if s == 0:
                samples, _ = model.stage1_samples(depth_values, self.ndepths[0], sh, sw,
                                                  self.inverse_depth)
            else:
                samples, _ = model.cascade_samples(depth.detach(), self.ndepths[s],
                                                   self.interval_ratio[s] * step,
                                                   self.inverse_depth)
                samples = F.interpolate(samples, size=(sh, sw), mode="bilinear",
                                        align_corners=False)
            rel = model.relative_projections(proj_matrices[f"stage{{s + 1}}"])
            cost = model.cost_pass(f, rel, samples.contiguous())
            logits = self.cost_regularization[s](cost.permute(0, 4, 1, 2, 3)).squeeze(1)
            prob = torch.softmax(logits, dim=1)
            depth = (prob * samples).sum(1)
            out[f"stage{{s + 1}}"] = {{"depth": depth, "prob_volume": prob}}
        out["depth"], out["photometric_confidence"] = depth, prob.max(1).values
        return out


def build(config, device, scale=SCALE):
    with torch.device("meta"):
        net = LinearCascade(config["ndepths"], config["interval_ratio"],
                            config["inverse_depth"], scale)
    return net.to_empty(device=device)
'''


@pytest.fixture
def cell(tiny_bench, monkeypatch):
    """Writes the cell ``tiny_linear`` with the reference's layer norm
    scaled by ``scale``; returns (run, the Configs the program was built
    from)."""
    root, bench = tiny_bench
    seen = []

    def make(scale: float):
        (bench / "reference" / "linear_cascade.py").write_text(REFERENCE.format(scale=scale))
        base = json.loads((bench / "configs" / "tiny_dmvsnet_dtu.json").read_text())
        config = {**base, "reference": "linear_cascade", "program": {"warp_impl": "torch"}}
        (bench / "configs" / "tiny_linear.json").write_text(json.dumps(config))
        w = json.loads((bench / "workloads" / "tiny_dtu_eval.json").read_text())
        (bench / "workloads" / "tiny_linear.json").write_text(
            json.dumps({**w, "config": "tiny_linear"}))
        doc = json.loads((root / "BENCHMARK.json").read_text())
        for m in doc["end_to_end"] + doc["per_layer"]:
            if "tiny_dtu_eval" in m.get("workloads", []) and "tiny_linear" not in m["workloads"]:
                m["workloads"].append("tiny_linear")
        (root / "BENCHMARK.json").write_text(json.dumps(doc))

        def build_model(cfg, device):
            seen.append(cfg)
            module = harness.reference_module(config, bench)
            return module.build(config, device, scale=1.0).eval()

        monkeypatch.setattr(evaluate, "build_model", build_model)

    def run(scale: float, traced: bool):
        make(scale)
        lines = []
        result = harness.run("tiny_linear", SEED, 0.3, traced, device="cpu", bench_dir=bench,
                             root=root, log=lambda line, **k: lines.append(line))
        info = json.loads(next(x for x in lines if x.startswith("info ")).split(" ", 1)[1])
        return result, info

    return run, seen


def test_another_architecture_runs_checks_and_counts_with_new_files(cell):
    run, seen = cell
    result, info = run(1.0, True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(cfg.warp_impl == "torch" for cfg in seen) and seen
    # spanned where the model has them: its feature path and its one
    # regularisation a stage; it has no refine U-Nets and calls no
    # aggregate_cost_volume, so cost_pass_ms.eval reads nothing
    assert {"feature_ms.eval", "costreg_ms.eval"} <= set(result["metrics"])
    assert "cost_pass_ms.eval" not in result["metrics"]
    # the count ran the reference on the meta device: one cost pass a stage
    assert [p[1] for p in info["count"]["passes"]] == [VIEWS] * 3
    assert info["count"]["ops_per_unit"] > 0


def test_the_check_of_another_architecture_fails_when_its_layer_norm_is_off(cell):
    run, _ = cell
    result, _ = run(1.01, False)
    assert not result["correct"], result["checks"]

