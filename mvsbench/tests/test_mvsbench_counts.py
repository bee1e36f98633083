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
            out[where] = counts.eval_counter(ref, b["imgs"], b["proj_matrices"],
                                           b["depth_values"]).totals()
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
        out[where] = counts.train_counter(
            ref, b, lambda o, bb: ref_loss.mvs_loss(o, bb["depth"], bb["mask"], cfg.dlossw)
        ).totals()
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


def _formula_least_seconds(config: dict, workload: dict, peak_flops: float, peak_bytes: float,
                           backward: bool = False) -> float:
    """Kernel 1's least time as it was worked out before the count recorded
    its passes: six passes of every view at the shapes the configuration
    and the cell imply."""
    b, v = workload["batch"], workload["views"]
    h, w = workload["height"], workload["width"]
    n = len(config["ndepths"])
    total = 0.0
    for s, d in enumerate(config["ndepths"]):
        scale = 2 ** (n - s - 1)
        c = config["base_channels"] * 2 ** (n - 1 - s)
        for planes in (d, 4):
            shape = (b, v, planes, h // scale, w // scale, c)
            costs = counts.adjoint_cost(*shape) if backward else [counts.pass_cost(*shape)]
            total += sum(max(nb / peak_bytes, fl / peak_flops) for nb, fl in costs)
    return total


@pytest.mark.parametrize("cell", ["dtu_eval", "tank_eval", "dtu_train"])
def test_least_seconds_from_the_recorded_passes_equal_the_formula(cell):
    """At each cell's own shapes, on the meta device: the passes that the
    count of a training step records give the formula's least seconds bit
    for bit, forward and adjoint; an eval forward records the same forward
    passes and no adjoint."""
    workload, config = harness.cell_files(cell)
    peak = harness.peaks_for("NVIDIA H100 80GB HBM3")
    args = (peak["fp32_flops_per_s"], peak["bytes_per_s"])
    meta = _inputs(workload, config, "meta", meta=True)
    ref = harness.reference_module(config).build(config, "meta")
    with torch.no_grad():
        forward = counts.eval_counter(ref, meta["imgs"], meta["proj_matrices"],
                                      meta["depth_values"]).passes
    for p in ref.parameters():
        p.requires_grad_(True)
    step = counts.train_counter(
        ref, meta, lambda o, bb: ref_loss.mvs_loss(o, bb["depth"], bb["mask"], config["dlossw"]))
    assert len(forward) == len(step.passes) == 6
    assert [p["shape"] for p in forward] == [p["shape"] for p in step.passes]
    assert not any(p["adjoint"] for p in forward) and all(p["adjoint"] for p in step.passes)
    for backward in (False, True):
        want = _formula_least_seconds(config, workload, *args, backward=backward)
        assert counts.warp_correlate_least_seconds(step.passes, *args, backward=backward) == want
    assert counts.warp_correlate_least_seconds(forward, *args) == _formula_least_seconds(
        config, workload, *args)
    assert counts.warp_correlate_least_seconds(forward, *args, backward=True) == 0.0


@pytest.mark.parametrize("norm,shape", [(lambda: torch.nn.LayerNorm(8), (2, 5, 8)),
                                        (lambda: torch.nn.GroupNorm(2, 8), (2, 8, 3, 5))],
                         ids=["layer_norm", "group_norm"])
def test_layer_and_group_norm_count_as_batch_norm_with_batch_statistics(norm, shape):
    module, x = norm(), torch.zeros(shape, requires_grad=True)
    with counts.counting() as counter:
        module(x)
    assert {k: v for k, v in counter.flops.items() if v} == {"norm": 7 * x.numel()}
    with counts.counting() as counter:
        module(x).sum().backward()
    assert counter.flops["norm"] == (7 + 8) * x.numel()
