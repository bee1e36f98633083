"""The slice as a whole: the port's MVSNet vs the JAX MVSNet with identical
weights, at the shape of tests/test_reference_parity.py (64x96, 3 views,
ndepths 8/8/8, interval ratios 4/2/1, inverse depth).

The weights start on the port's side (seeded init, then random batch-norm
statistics) and reach JAX through tools/convert_torch_ckpt.convert_state_dict,
so the file runs one jitted JAX forward and no JAX init.

Tolerances: depth max |diff| <= 0.01 mm, photometric_confidence max
|diff| <= 1e-4 (NUMERICS.json "tol", max 10 mm / mean 0.2 mm, is the
outer bound; fp32 on both sides leaves only reassociation noise).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402

DEPTH_TOL_MM = 0.01
CONF_TOL = 1e-4
NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)


@pytest.fixture(scope="module")
def outputs():
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="torch")
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    model.eval()

    batch = synthetic.make_batch(batch=1, n_views=3, height=64, width=96, n_depths=32)
    with torch.inference_mode():
        t_out = model(torch.from_numpy(batch["imgs"]),
                      {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                      torch.from_numpy(batch["depth_values"]))

    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True)
    j_out = jax.jit(jm.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
        jnp.asarray(batch["depth_values"]),
    )
    return t_out, jax.tree_util.tree_map(np.asarray, j_out)


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_final_depth_and_confidence_match_jax(outputs):
    t_out, j_out = outputs
    depth = t_out["depth"].numpy()
    assert depth.shape == (1, 64, 96) and np.isfinite(depth).all()
    dd = _maxdiff(depth, j_out["depth"])
    dc = _maxdiff(t_out["photometric_confidence"].numpy(), j_out["photometric_confidence"])
    print(f"slice parity: depth max |diff| {dd:.3e} mm, confidence max |diff| {dc:.3e}")
    assert dd <= DEPTH_TOL_MM
    assert dc <= CONF_TOL


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_stage_outputs_match_jax(outputs, stage):
    t_out, j_out = outputs
    t_s, j_s = t_out[stage], j_out[stage]
    for k in ("depth", "depth_sub_plus", "depth_sub_plus_refine", "depth_values_c"):
        d = _maxdiff(t_s[k].numpy(), j_s[k])
        print(f"{stage} {k}: max |diff| {d:.3e} mm")
        assert d <= DEPTH_TOL_MM, (stage, k, d)
    for k in ("photometric_confidence", "photometric_confidence_refine"):
        assert _maxdiff(t_s[k].numpy(), j_s[k]) <= CONF_TOL, (stage, k)
    # the merge keeps the first-pass confidence as the stage's confidence
    np.testing.assert_array_equal(t_out["photometric_confidence"].numpy(),
                                  t_out["stage3"]["photometric_confidence"].numpy())
