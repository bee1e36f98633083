"""``MVSNet(run_stages=...)``, the JAX package's truncated forward, in the
port: at the shape of tests/test_torch_slice.py (64x96, 3 views, ndepths
8/8/8, interval ratios 4/2/1, inverse depth), eval, fp32.

run_stages=1.6 stops after the stage-2 cost U-Net: its output
``outputs["partial"]`` (B, D, H, W, 4) is held against one jitted forward
of the JAX MVSNet at run_stages=1.6 on the same weights, within 1e-4 of its
largest magnitude.  The other stop points are held against the
intermediates of the port's own full forward, captured on the way
(hooks on the cost passes and the U-Nets): a truncated forward runs the
same operations up to its stop, so they agree bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.ops import warp_correlate
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402

NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
PARTIAL_RTOL = 1e-4


def _model(run_stages: float = 0) -> MVSNet:
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="torch", run_stages=run_stages)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


@pytest.fixture(scope="module")
def batch():
    torch.set_num_threads(2)
    return synthetic.make_batch(batch=1, n_views=3, height=64, width=96, n_depths=32)


def _args(batch):
    return (torch.from_numpy(batch["imgs"]),
            {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
            torch.from_numpy(batch["depth_values"]))


@pytest.fixture(scope="module")
def full(batch):
    """The full forward and what it passed through: per stage the
    hypotheses, both cost volumes and both U-Net outputs (B, D, H, W, C)."""
    model = _model()
    costs, regs = [], []
    real = warp_correlate.aggregate_cost_volume

    def recording(*args):
        out = real(*args)
        costs.append(out)
        return out

    hooks = [reg.register_forward_hook(lambda m, a, out: regs.append(out.permute(0, 2, 3, 4, 1)))
             for pair in zip(model.cost_regularization, model.cost_regularization_refine)
             for reg in pair]
    warp_correlate.aggregate_cost_volume = recording
    try:
        with torch.inference_mode():
            out = model(*_args(batch))
    finally:
        warp_correlate.aggregate_cost_volume = real
        for h in hooks:
            h.remove()
    return out, costs, regs


def test_run_stages_partial_matches_jax(batch):
    model = _model(run_stages=1.6)
    with torch.inference_mode():
        got = model(*_args(batch))
    assert set(got) == {"stage1", "partial", *got["stage1"]}
    assert got["partial"].shape == (1, 8, 32, 48, 4)

    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 run_stages=1.6)
    want = np.asarray(jax.jit(jm.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
        jnp.asarray(batch["depth_values"]))["partial"])
    diff = float(np.abs(got["partial"].numpy() - want).max())
    print(f"run_stages=1.6 partial: max |diff| {diff:.3e} of max |jax| {np.abs(want).max():.3e}")
    assert diff <= PARTIAL_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("run_stages,what", [
    (0.2, "hypotheses"), (0.4, "cost"), (0.8, "refine cost"), (0.9, "refine U-Net"),
    (2.4, "cost"), (2, "whole"), (0, "whole"),
])
def test_run_stages_stops_where_the_full_forward_passes(batch, full, run_stages, what):
    out, costs, regs = full
    model = _model(run_stages)
    with torch.inference_mode():
        got = model(*_args(batch))
    s = int(run_stages)
    if what == "whole":
        n = s or len(NDEPTHS)
        assert "partial" not in got
        assert sorted(k for k in got if k.startswith("stage")) == [f"stage{i + 1}" for i in range(n)]
        for k, v in got[f"stage{n}"].items():
            assert torch.equal(v, out[f"stage{n}"][k]), k
        return
    want = {"hypotheses": out[f"stage{s + 1}"]["depth_values"], "cost": costs[2 * s],
            "refine cost": costs[2 * s + 1], "refine U-Net": regs[2 * s + 1]}[what]
    assert torch.equal(got["partial"], want)
    assert sorted(k for k in got if k.startswith("stage")) == [f"stage{i + 1}" for i in range(s)]
