"""Faults planted under the timed path, for the readings that set the
limits of ``correct`` (``mvsbench/calibrate.py``) and for the tests that
see ``correct`` come out false.  Each patches the program's step factories
in ``dmvsnet_tpu_torch.engine.steps`` (the modes look them up there at
set-up), never the benchmark's own code.

* ``altered``: an answer altered where it is produced: the first depth map
  of each dispatch 10 ppm too deep (eval), the loss 1% off before its
  backward (train);
* ``half_batch``: half of the batch left out, the mean taken over the rest
  (eval: the answers of the first half stand for the whole batch);
* ``unchanged``: a training step that returns its state unchanged
  (parameters, buffers and optimizer state restored after the step);
* ``no_exchange``: the gradients' exchange between the ranks left out
  (``engine.train.data_parallel`` hands back the bare model, no DDP).

A fault planted in a run's process reaches the ranks it starts through the
environment (``ENV``): ``mvsbench/rank.py`` plants it there too.
"""

from __future__ import annotations

import contextlib
import os

import torch

KINDS = ("altered", "half_batch", "unchanged", "no_exchange")
ENV = "MVSBENCH_FAULT"


def _half(tree, n: int):
    if isinstance(tree, dict):
        return {k: _half(v, n) for k, v in tree.items()}
    return tree[:n]


@contextlib.contextmanager
def planted(kind: str):
    from dmvsnet_tpu_torch.engine import steps, train

    real_infer, real_train, real_loss = steps.make_infer_step, steps.make_train_step, \
        steps.mvs_loss

    def infer_factory():
        infer = real_infer()

        def broken(model, imgs, proj, dv):
            if kind == "half_batch":
                n = max(1, imgs.shape[0] // 2)
                depth, conf = infer(model, imgs[:n], _half(proj, n), dv[:n])
                reps = -(-imgs.shape[0] // n)
                return depth.repeat(reps, 1, 1)[:imgs.shape[0]], \
                    conf.repeat(reps, 1, 1)[:imgs.shape[0]]
            depth, conf = infer(model, imgs, proj, dv)
            if kind == "altered":
                depth = depth.clone()
                depth[0] *= 1.0 + 1e-5
            return depth, conf
        return broken

    def train_factory(*args, **kwargs):
        step = real_train(*args, **kwargs)

        def broken(net, optimizer, scheduler, batch):
            if kind == "half_batch":
                n = max(1, batch["imgs"].shape[0] // 2)
                return step(net, optimizer, scheduler, _half(batch, n))
            if kind == "unchanged":
                params = {k: v.detach().clone() for k, v in net.state_dict().items()}
                opt_state = {p: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                             for p, s in optimizer.state.items()}
                lrs = [g["lr"] for g in optimizer.param_groups]
                sched = scheduler.state_dict()
                out = step(net, optimizer, scheduler, batch)
                net.load_state_dict(params)
                optimizer.state.clear()
                optimizer.state.update(opt_state)
                for g, lr in zip(optimizer.param_groups, lrs):
                    g["lr"] = lr
                scheduler.load_state_dict(sched)
                return out
            return step(net, optimizer, scheduler, batch)
        return broken

    def altered_loss(*args, **kwargs):
        return real_loss(*args, **kwargs) * 1.01

    real_dp = train.data_parallel
    steps.make_infer_step, steps.make_train_step = infer_factory, train_factory
    if kind == "altered":
        steps.mvs_loss = altered_loss
    if kind == "no_exchange":
        train.data_parallel = lambda model: model
    os.environ[ENV] = kind
    try:
        yield
    finally:
        del os.environ[ENV]
        steps.make_infer_step, steps.make_train_step = real_infer, real_train
        steps.mvs_loss = real_loss
        train.data_parallel = real_dp
