"""The frozen reference against the program on the CPU, at 64x96, 3 views,
8/8/8 planes, on the benchmark's own weights and scenes: an eval forward
(unfolded, to float32 rounding; folded, as the timed path runs it, within
the cell's limits of ``correct``) and one training step."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from dmvsnet_tpu_torch.engine.state import make_lr_schedule, make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.engine.train import build_model
from dmvsnet_tpu_torch.models import blocks
from mvsbench import harness, program, weights
from mvsbench.reference import loss as ref_loss
from mvsbench.reference import model as reference
from mvsbench.traffic import scenes

SEED = 3_000_000_019


def _setup(cell: str):
    workload, config = harness.cell_files(cell)
    config = {**config, "ndepths": [8, 8, 8]}
    workload = {**workload, "height": 64, "width": 96, "views": 3}
    ctx = SimpleNamespace(config=config, workload=workload, seed=SEED, options={}, device="cpu")
    cfg = program.config(ctx)
    model = build_model(cfg, torch.device("cpu"))
    sd = weights.generate(model.state_dict(), SEED, "cpu")
    model.load_state_dict(sd)
    ref = reference.build(config, "cpu")
    ref.load_state_dict(sd)
    pool = scenes.pool(SEED, workload["traffic"], 3, 64, 96, 3, cfg.numdepth, "cpu")
    batch = scenes.batches(pool, workload["batch"], 1)[0]
    tree = lambda v: {k: tree(x) for k, x in v.items()} if isinstance(v, dict) \
        else torch.from_numpy(v)  # noqa: E731
    return cfg, model, ref, {k: tree(v) for k, v in batch.items()}, workload


@pytest.mark.parametrize("cell", ["dtu_eval", "tank_eval"])
def test_reference_forward_matches_the_program(cell):
    cfg, model, ref, batch, workload = _setup(cell)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    model.eval()
    with torch.no_grad():
        want = ref.eval()(*args)
    # with autograd on, the program runs every block unfolded: the
    # reference's arithmetic, op for op
    blocks.reset_fold_stats()
    with torch.enable_grad():
        got = model(*args)
    assert blocks.fold_stats()["folded"] == 0 < blocks.fold_stats()["unfolded"]
    for s in ("stage1", "stage2", "stage3"):
        for key in ("depth", "prob_volume", "photometric_confidence", "depth_sub_plus",
                    "depth_sub_plus_refine", "depth_values_c"):
            torch.testing.assert_close(got[s][key].detach(), want[s][key], rtol=1e-6,
                                       atol=1e-5, msg=f"{s} {key}")
    # with autograd off, as the timed path runs it, each eval norm is folded
    # into its convolution, which rounds in another order: the cell's own
    # limits of correct hold it
    blocks.reset_fold_stats()
    with torch.no_grad():
        folded = model(*args)
    assert blocks.fold_stats()["folded"] > 0
    limits = workload["limits"]
    for s in ("stage1", "stage2", "stage3"):
        gap = (folded[s]["depth"] - want[s]["depth"]).abs().flatten(1).mean(1, dtype=torch.float64)
        assert float(gap.max()) <= limits["depth_mean_mm"], (s, float(gap.max()))
        prob = float((folded[s]["prob_volume"] - want[s]["prob_volume"]).abs().max())
        assert prob <= limits["prob"], (s, prob)


def test_reference_training_step_matches_the_program():
    cfg, model, ref, batch, workload = _setup("dtu_train")
    t = workload["training"]
    schedule = make_lr_schedule(cfg.lr, t["steps_per_epoch"], cfg.scheduler, cfg.warmup,
                                cfg.milestones, cfg.lr_decay, cfg.epochs)
    optimizer, scheduler = make_optimizer(model.parameters(), schedule, cfg.wd)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    scalars, _ = make_train_step(tuple(cfg.dlossw))(model, optimizer, scheduler, batch)

    ref.train()
    params = dict(ref.named_parameters())
    out = ref(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    loss = ref_loss.mvs_loss(out, batch["depth"], batch["mask"], cfg.dlossw)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in params.items()}
    ref_loss.Adam(list(params.values())).step(
        ref_loss.steplr(0, t["lr"], t["steps_per_epoch"], t["warmup"], t["milestones"],
                        t["lr_decay"]))

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    assert math.isclose(float(scalars["loss"]), float(loss.detach()), rel_tol=1e-6)
    for n, p in model.named_parameters():
        # elementwise, the sums of the convolutions' weight gradients round
        # differently; by norm they agree to float32 rounding
        assert rel(optimizer.state[p]["exp_avg"] / 0.1, grads[n]) < 1e-5, n
        assert rel(p.detach() - before[n], params[n].detach() - before[n]) < 1e-3, n
    for n, b in model.named_buffers():
        if b.is_floating_point():
            assert rel(b, ref.state_dict()[n]) < 1e-6, n
