"""The frozen count (``mvsbench/counts``, on the frozen reference) against
the program's own ``engine/profiler.cost_analysis`` at the same shapes: at a
small shape on the CPU, and at the cells' shapes on the card (``-m cuda``,
which prints both counts)."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from dmvsnet_tpu_torch.engine import profiler
from dmvsnet_tpu_torch.engine.train import build_model
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from mvsbench import harness, program
from mvsbench.counts import cost as counts
from mvsbench.reference import loss as ref_loss
from mvsbench.reference import model as reference


def _inputs(workload: dict, config: dict, device, meta: bool = False) -> dict:
    b, v, h, w = workload["batch"], workload["views"], workload["height"], workload["width"]
    dev = "meta" if meta else device
    gen = torch.Generator(device="cpu").manual_seed(0)

    def make(shape, lo, hi):
        x = torch.rand(shape, generator=gen) * (hi - lo) + lo
        return torch.empty(shape, device="meta") if meta else x.to(dev)

    cams = torch.eye(4).repeat(b, v, 2, 1, 1)
    cams[..., 1, 0, 0] = cams[..., 1, 1, 1] = 1.2 * w
    cams[..., 1, 0, 2], cams[..., 1, 1, 2] = w / 2, h / 2
    cams[:, 1:, 0, 0, 3] = -5.0
    proj = {}
    for s in range(3):
        p = cams.clone()
        p[..., 1, :2, :] *= 2.0 ** (s - 2)
        proj[f"stage{s + 1}"] = torch.empty(p.shape, device="meta") if meta else p.to(dev)
    lo, hi = workload["traffic"]["depth_range"]
    dv = torch.linspace(lo, hi, config["numdepth"]).repeat(b, 1)
    out = {"imgs": make((b, v, h, w, 3), 0.0, 1.0), "proj_matrices": proj,
           "depth_values": torch.empty(dv.shape, device="meta") if meta else dv.to(dev),
           "depth": {}, "mask": {}}
    for s in range(3):
        k = 2 ** (2 - s)
        out["depth"][f"stage{s + 1}"] = make((b, h // k, w // k), 500.0, 800.0)
        out["mask"][f"stage{s + 1}"] = make((b, h // k, w // k), 1.0, 1.0)
    return out


def _counts(cell: str, device, **sizes) -> dict:
    workload, config = harness.cell_files(cell)
    workload = {**workload, **sizes.pop("workload", {})}
    config = {**config, **sizes.pop("config", {})}
    ctx = SimpleNamespace(config=config, workload=workload, seed=1, options={},
                          device=str(device))
    cfg = program.config(ctx)
    model = build_model(cfg, torch.device(device))
    batch = _inputs(workload, config, device)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    meta = _inputs(workload, config, device, meta=True)
    out = {"cell": cell}
    if workload["mode"] == "infer":
        model.eval()
        with torch.no_grad():
            out["program"] = profiler.cost_analysis(model, *args)
        for where, b in (("frozen_meta", meta), ("frozen_device", batch)):
            ref = reference.build(config, "meta" if b is meta else device)
            out[where] = counts.eval_cost(ref, b["imgs"], b["proj_matrices"], b["depth_values"])
        return out
    model.train()

    def step():
        o = model(*args)
        mvs_loss(o, batch["depth"], batch["mask"], cfg.depth_mode, tuple(cfg.dlossw)).backward()

    out["program"] = profiler.cost_analysis(step)
    for where, b in (("frozen_meta", meta), ("frozen_device", batch)):
        ref = reference.build(config, "meta" if b is meta else device)
        if b is batch:
            ref.load_state_dict(model.state_dict())
        for p in ref.parameters():
            p.requires_grad_(True)
        out[where] = counts.train_cost(
            ref, b, lambda o, bb: ref_loss.mvs_loss(o, bb["depth"], bb["mask"], cfg.dlossw))
    return out


def _check(got: dict) -> None:
    """Equal to the operation and the byte on the program's device; on the
    meta device (what the traced run counts) equal in operations: a batch
    norm's saved statistics have other sizes there, which moves bytes
    alone."""
    assert got["frozen_device"] == got["program"], got
    assert got["frozen_meta"]["flops"] == got["program"]["flops"], got
    assert got["program"]["flops"] > 0


SMALL = {"workload": {"height": 64, "width": 96, "views": 3}, "config": {"ndepths": [8, 8, 8]}}


@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train", "tank_eval"])
def test_frozen_count_equals_the_programs_at_a_small_shape(cell):
    _check(_counts(cell, "cpu", **json.loads(json.dumps(SMALL))))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train", "tank_eval"])
def test_frozen_count_equals_the_programs_at_the_cells_shapes(card, cell):
    from dmvsnet_tpu_torch import pin_fp32

    pin_fp32()
    got = _counts(cell, card)
    print("counts " + json.dumps(got), flush=True)
    _check(got)
