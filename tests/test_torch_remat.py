"""remat (``MVSNet(remat=True)``, ``--remat``) against the same step without
it, on the port alone: the JAX package holds its own remat step equal to
its step without remat (tests/test_model.py), and the port's step without
remat is held against the JAX step in tests/test_torch_train_step.py, so
no JAX function runs here.

One train step (32x64, 3 views, batch 1, ndepths 8/8/8, inverse depth,
learning rate 0 so the gradients stay in ``.grad``) with and without remat,
for fp32, ``compute_dtype=bfloat16``, ``agg_mode="adaptive"`` and
``fold_level0=True`` (every U-Net level 0 and the feature net folded, whose
batch norms a recompute must not update either); and one
training step through the CLI with ``--remat`` against the same without
it.  The dp step on 2 gloo ranks with and without remat, where the
recomputed synced batch norms all_reduce again inside the backward, is
held the same way in tests/test_torch_train_step.py, whose ranks run it
beside the dp step it already holds against JAX.

Tolerance: equal bit for bit (loss, depth, every gradient, every running
statistic and ``num_batches_tracked``), under
``torch.use_deterministic_algorithms(True)``.  Without it two runs of the
same step already differ in the last bits on the CPU (the plain cost
pass's gather has a scatter-add backward whose order varies), with or
without remat.  A recompute that updated the running statistics again, or
saw another stage's cameras, shows as a difference of order 1.
"""

import contextlib

import numpy as np
import pytest
import torch

from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic

NDEPTHS, RATIOS, DLOSSW, V = (8, 8, 8), (4, 2, 1), (0.5, 1.0, 2.0), 3
H, W = 32, 64
VARIANTS = {"fp32": {}, "bf16": dict(dtype=torch.bfloat16), "adaptive": dict(agg_mode="adaptive"),
            "fold": dict(fold_level0=True)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs beside other workers, where a
    process that spins a thread per core slows every one of them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@contextlib.contextmanager
def deterministic():
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def _weights(agg_mode: str = "variance") -> dict:
    """Seeded init, random batch-norm parameters and statistics, damped
    probability heads (as tests/test_torch_train_step.py)."""
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="torch", agg_mode=agg_mode)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _batch() -> dict:
    batch = synthetic.make_batch(batch=1, n_views=V, height=H, width=W, n_depths=32)
    rng = np.random.default_rng(0)
    batch["imgs"] = (batch["imgs"] + rng.normal(0, 0.02, batch["imgs"].shape)).astype(np.float32)

    def move(v):
        return {k: move(x) for k, x in v.items()} if isinstance(v, dict) else torch.from_numpy(v)

    return move(batch)


def _step(sd: dict, batch: dict, remat: bool, **kw) -> dict:
    """One train step; also the number of cost passes the kernel's wrapper
    ran (forward and recompute)."""
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="cuda", remat=remat, **kw)  # CPU tensors: the plain version
    model.load_state_dict(sd)
    calls = []
    real = wc.warp_correlate

    def counting(*args):
        calls.append(1)
        return real(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(wc, "warp_correlate", counting)
    try:
        opt, sched = make_optimizer(model.parameters(), lambda n: 0.0)
        scalars, (depth, _) = make_train_step(DLOSSW)(model, opt, sched, batch)
    finally:
        mp.undo()
    return dict(scalars={k: float(v) for k, v in scalars.items()}, depth=depth,
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                state=model.state_dict(), passes=len(calls))


@pytest.fixture(scope="module")
def steps():
    sd = {"variance": _weights(), "adaptive": _weights("adaptive")}
    batch = _batch()
    out = {}
    with deterministic():
        for name, kw in VARIANTS.items():
            weights = sd[kw.get("agg_mode", "variance")]
            out[name] = {remat: _step(weights, batch, remat, **kw) for remat in (False, True)}
    return out


def _assert_equal(a: dict, b: dict) -> None:
    assert a["scalars"] == b["scalars"]
    assert torch.equal(a["depth"], b["depth"])
    assert a["grads"].keys() == b["grads"].keys()
    for n, g in a["grads"].items():
        assert torch.equal(g, b["grads"][n]), n
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_step_equals_step(steps, variant):
    off, on = steps[variant][False], steps[variant][True]
    assert np.isfinite(off["scalars"]["loss"])
    _assert_equal(off, on)
    # every running statistic moved once: one update per step
    tracked = {k: int(v) for k, v in on["state"].items() if k.endswith("num_batches_tracked")}
    for k, n in tracked.items():
        assert n == (V - 1 if k.startswith("agg_weight") else 1), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_recomputes_the_cost_passes(steps, variant):
    """Six cost passes a forward; remat runs them again in the backward,
    except the adaptive ones (one kernel-1 launch per source view), which
    it leaves out, as the JAX package does."""
    off, on = steps[variant][False], steps[variant][True]
    if variant == "adaptive":
        assert off["passes"] == on["passes"] == 6 * (V - 1)
    else:
        assert (off["passes"], on["passes"]) == (6, 12)


def test_cli_trains_with_remat(tmp_path):
    data = tmp_path / "dtu"
    synthetic.write_dtu_training_tree(str(data), n_views=V, height=H, width=W)
    argv = ["--device", "cpu", "--datapath", str(data), "--trainlist", "scan1",
            "--testlist", "scan1", "--nviews", str(V), "--batch_size", "1", "--epochs", "1",
            "--ndepths", *map(str, NDEPTHS), "--numdepth", "16", "--img_size", str(H), str(W),
            "--max_train_samples", "1", "--max_val_samples", "1"]
    states = {}
    with deterministic():
        for flags in ([], ["--remat"]):
            log_dir = tmp_path / ("logs_remat" if flags else "logs")
            summary = cli.main(argv + ["--log_dir", str(log_dir)] + flags)
            assert summary["step"] == 1
            states[bool(flags)] = torch.load(summary["history"][0]["checkpoint"],
                                             weights_only=True)["model"]
    assert states[False].keys() == states[True].keys()
    for k, v in states[False].items():
        assert torch.equal(v, states[True][k]), k
