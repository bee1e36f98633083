"""Mode ``train``: training steps as ``Trainer.train`` runs them, closed loop.

Set-up builds one training object as the ``Trainer`` does on one process
(``engine.train.build_model`` on a one-rank mesh, the benchmark's seeded
weights, ``engine.state.make_optimizer`` with ``make_lr_schedule``,
``engine.train.data_parallel``, ``engine.steps.make_train_step``) and
drives it through its first three steps with the window's own call and
feed, on three batches whose rows all differ.  That same object then runs
the window: batches moved as ``Trainer.to_device`` moves them, no sync per
step, scalars accumulated on the device.

The reference (the configuration's, ``harness.reference_module``: plain
model and loss, ``mvsbench/reference/loss.py``'s Adam, fp32, TF32 off)
follows the first three steps from the same weights on the same batches.
Compared, once the window has closed:

* ``loss``: the largest relative gap of the three steps' losses;
* ``grad``: the first gradient, as the optimizer got it (Adam's first
  moment after one step over 1 - beta1), by the worst parameter: the gap
  between the two norms over the larger of the reference's norm and the
  median parameter's;
* ``update``: the parameters' change over the three steps, by the worst
  parameter, the same measure; parameters whose reference gradient is under
  a thousandth of the median parameter's are left out (Adam moves them by
  round-off alone);
* ``stats``: the batch norms' running statistics' change in the first
  step, by the worst buffer, the same measure (over three steps the
  parameters' round-off, amplified by Adam's first steps, dominates it).
  Only the state dict's buffers count (a non-persistent buffer is a
  constant), and a model without any has no ``stats``.

The run's ``checked`` line names the parameter or buffer that gave each of
the last three.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch
from torch.utils import checkpoint as torch_checkpoint

from mvsbench import harness, program, weights
from mvsbench.counts import cost as counts
from mvsbench.reference import loss as ref_loss
from mvsbench.reference import model as reference
from mvsbench.traffic import scenes

KIND = "train"
SCENE_SEED_OFFSET = 1_000_003
CHECKED_STEPS = 3
BETA1 = 0.9


def _snapshot(model) -> dict[str, torch.Tensor]:
    """The float entries of the state dict: parameters and persistent buffers
    (a non-persistent buffer is a constant the seed does not fill)."""
    return {n: v.detach().clone() for n, v in model.state_dict().items()
            if v.is_floating_point()}


def setup(ctx):
    device = program.device(ctx)
    from dmvsnet_tpu_torch.parallel import mesh as program_mesh

    state = build(ctx, device, program_mesh.make_mesh(1, device=device), 0, 1)
    checked_steps(state)
    return state


def build(ctx, device, mesh, rank: int, world: int):
    """The training object of the cell on ``mesh``: rank ``rank`` of
    ``world`` loads its share of each global batch (``workload["batch"]``
    samples), as the Trainer's loader shards by the dp coordinate."""
    program.package()
    from dmvsnet_tpu_torch.engine import state as program_state
    from dmvsnet_tpu_torch.engine import steps, train
    from dmvsnet_tpu_torch.ops import cuda_build
    from dmvsnet_tpu_torch.parallel import mesh as program_mesh

    marks = [("start", time.perf_counter())]
    cfg = program.config(ctx)
    w = ctx.workload
    model = train.build_model(cfg, device, mesh)
    sd = weights.generate(model.state_dict(), ctx.seed, device)
    model.load_state_dict(sd)
    schedule = program_state.make_lr_schedule(
        cfg.lr, w["training"]["steps_per_epoch"], cfg.scheduler, cfg.warmup, cfg.milestones,
        cfg.lr_decay, cfg.epochs)
    optimizer, scheduler = program_state.make_optimizer(model.parameters(), schedule, cfg.wd)
    num_stage = len(cfg.ndepths)
    marks.append(("model", time.perf_counter()))
    pool = scenes.pool(ctx.seed + SCENE_SEED_OFFSET, w["traffic"], w["views"], w["height"],
                       w["width"], num_stage, cfg.numdepth, device)
    count = len(pool) // math.gcd(len(pool), w["batch"])
    if count < CHECKED_STEPS:
        raise ValueError(f"a pool of {len(pool)} scenes gives {count} distinct batches; the "
                         f"check needs {CHECKED_STEPS}")
    whole = scenes.batches(pool, w["batch"], count)
    per = w["batch"] // world
    mine = [{k: _rows(v, rank * per, (rank + 1) * per) for k, v in b.items()} for b in whole]
    state = SimpleNamespace(
        ctx=ctx, device=device, mesh=mesh, model=model, net=train.data_parallel(model),
        optimizer=optimizer, scheduler=scheduler, cfg=cfg,
        step=steps.make_train_step(tuple(cfg.dlossw), cfg.depth_mode, mesh),
        meter=train.AverageMeter(), shard=program_mesh.shard_batch, batches=mine,
        ref_batches=whole, k=0, steps=0, cuda_build=cuda_build, num_stage=num_stage,
        losses=[], marks=marks, sd=sd)
    marks.append(("scenes", time.perf_counter()))
    return state


def _rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def checked_steps(state) -> None:
    """The first three steps, through the window's own call and feed, with
    what the check compares kept: the weights before, the first gradient
    and running statistics, the weights after the three."""
    model = state.model
    state.theta0 = {k: v for k, v in state.sd.items() if v.is_floating_point()}
    for i in range(CHECKED_STEPS):
        state.losses.append(_step(state)["loss"])
        if i == 0:
            state.grad1 = {n: state.optimizer.state[p]["exp_avg"].detach() / (1.0 - BETA1)
                           for n, p in model.named_parameters() if p in state.optimizer.state}
            state.stats1 = {n: b.detach().clone() for n, b in model.named_buffers()
                            if n in state.theta0}
    state.theta3 = _snapshot(model)
    state.losses = [float(x) for x in state.losses]
    state.marks.append(("checked_steps", time.perf_counter()))
    state.cuda_build.reset_launches()
    state.steps = 0


def _step(state) -> dict:
    host = state.batches[state.k % len(state.batches)]
    batch = state.shard({k: v for k, v in host.items() if k != "filename"}, state.mesh)
    scalars, _ = state.step(state.net, state.optimizer, state.scheduler, batch)
    state.meter.update(scalars)
    state.k += 1
    return scalars


def iterate(state) -> None:
    _step(state)
    state.steps += 1


def drain(state) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize()


def units(state) -> int:
    return state.steps * state.ctx.workload["batch"]


def end_to_end(state, window_s: float) -> dict:
    return {"train_samples_per_s": units(state) / window_s}


def info(state) -> dict:
    launches = state.cuda_build.launches()
    return {"steps": state.steps, "losses": state.losses,
            "launches_per_step": {k: v / state.steps for k, v in launches.items() if v}
            if state.steps else {},
            "build_s": state.cuda_build.BUILD_INFO["seconds"],
            "setup_phases_s": {m[0]: m[1] - p[1] for p, m in zip(state.marks, state.marks[1:])}}


def spans(state, spans, stack) -> None:
    from mvsbench.spans import wrap

    wrap(torch.Tensor, "backward", spans, "backward", stack)


def _reference(ctx, device):
    """The configuration's reference model on ``device`` and its loss
    ``(outputs, batch) -> loss``."""
    module = harness.reference_module(ctx.config, ctx.bench_dir)
    mvs_loss = getattr(module, "mvs_loss", ref_loss.mvs_loss)
    dlossw = tuple(ctx.config["dlossw"])
    return module.build(ctx.config, device), \
        lambda out, batch: mvs_loss(out, batch["depth"], batch["mask"], dlossw)


def _device_batch(host, device):
    def to(v):
        return {k: to(x) for k, x in v.items()} if isinstance(v, dict) else \
            torch.from_numpy(v).to(device)
    return {k: to(v) for k, v in host.items()}


def count(state) -> tuple[float, list[dict]]:
    """The frozen count of operations per sample of one training step
    (forward, loss, backward) at the cell's shapes, on the meta device, and
    the cost passes of one step."""
    ref, loss_fn = _reference(state.ctx, "meta")
    host = state.ref_batches[0]

    def meta(v):
        return {k: meta(x) for k, x in v.items()} if isinstance(v, dict) else \
            torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")

    batch = {k: meta(v) for k, v in host.items()}
    for p in ref.parameters():
        p.requires_grad_(True)
    counter = counts.train_counter(ref, batch, loss_fn)
    return counter.totals()["flops"] / state.ctx.workload["batch"], counter.passes


def _worst(prog: dict, want: dict, names) -> tuple[float, str]:
    """max over ``names`` of |‖prog‖ - ‖want‖| / max(‖want‖, median ‖want‖),
    and the name that gives it; a name missing from ``prog`` reads as a zero
    norm."""
    norms = {n: float(want[n].norm()) for n in names}
    med = sorted(norms.values())[len(norms) // 2]
    got = {n: float(prog[n].norm()) if n in prog else 0.0 for n in names}
    gaps = {n: abs(got[n] - norms[n]) / max(norms[n], med, 1e-30) for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def check(state) -> tuple[dict, int]:
    w = state.ctx.workload
    theta0, theta3, grad1 = state.theta0, state.theta3, state.grad1
    state.model = state.net = state.optimizer = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, loss_fn = _reference(state.ctx, state.device)
    ref.load_state_dict(state.sd)
    ref.train()
    params = dict(ref.named_parameters())
    adam = ref_loss.Adam(list(params.values()))
    t = w["training"]
    losses, grads, stats1 = [], None, None
    # the reference recomputes each cost pass in its backward: the plain
    # pass's gathers would otherwise keep every tap of every view
    real_pass = reference.cost_pass
    reference.cost_pass = lambda *a: torch_checkpoint.checkpoint(real_pass, *a,
                                                                 use_reentrant=False)
    try:
        for i in range(CHECKED_STEPS):
            batch = _device_batch(state.ref_batches[i], state.device)
            for p in params.values():
                p.grad = None
            out = ref(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            loss = loss_fn(out, batch)
            loss.backward()
            del out, batch
            losses.append(float(loss.detach()))
            if i == 0:
                grads = {n: p.grad.detach().clone() for n, p in params.items()}
                stats1 = {n: b.detach().clone() for n, b in ref.named_buffers()
                          if n in theta0}
            adam.step(ref_loss.steplr(i, t["lr"], t["steps_per_epoch"], t["warmup"],
                                      t["milestones"], t["lr_decay"]))
    finally:
        reference.cost_pass = real_pass
    theta_ref = {n: x.detach() for n, x in ref.state_dict().items() if n in theta0}
    names = list(params)
    norms = {n: float(grads[n].norm()) for n in names}
    med = sorted(norms.values())[len(norms) // 2]
    moving = [n for n in names if norms[n] >= 1e-3 * med]
    delta = lambda th: {n: th[n] - theta0[n] for n in th}  # noqa: E731
    worst = {"grad": _worst(grad1, grads, names),
             "update": _worst(delta(theta3), delta(theta_ref), moving)}
    if stats1:
        worst["stats"] = _worst(delta(state.stats1), delta(stats1), list(stats1))
    numbers = {"loss": max(abs(a - b) / abs(b) for a, b in zip(state.losses, losses)),
               **{k: v for k, (v, _) in worst.items()}}
    state.ref_losses = losses
    state.check_notes = {"worst": {k: n for k, (_, n) in worst.items()}}
    correct = all(v <= w["limits"][k] for k, v in numbers.items())
    return numbers, 0 if correct else units(state)
