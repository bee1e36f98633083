"""The weight bridge and the building blocks of the port vs the JAX package.

* ``state_dict_from_jax`` agrees key by key with
  tools/convert_torch_ckpt.export_state_dict and loads into the port's
  MVSNet with ``strict=True`` (it has no ``num_batches_tracked``, which
  batch norm fills in on load);
* one ConvBlock 2-D and 3-D and one DeconvBlock 2-D and 3-D match
  dmvsnet_tpu.models.blocks in eval mode, with random batch-norm
  statistics, within 1e-5.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu.models import blocks as jblocks
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch.convert import load_reference_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models import blocks as tblocks

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import export_state_dict  # noqa: E402

BLOCK_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(rng, params, stats):
    """Non-trivial batch norm: random scale/bias and running statistics."""
    def walk(node, fn, path=()):
        return {k: walk(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
                for k, v in node.items()}

    def p_fn(path, v):
        if path[-2:] == ("bn", "scale"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if path[-2:] == ("bn", "bias"):
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v)

    def s_fn(path, v):
        if path[-1] == "mean":
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    return walk(params, p_fn), walk(stats, s_fn)


def test_state_dict_matches_export_and_loads_strict(rng):
    batch = jsyn.make_batch(batch=1, n_views=2, height=32, width=32, n_depths=8)
    model = JMVSNet(ndepths=(8, 8, 8), depth_interval_ratio=(4, 2, 1))
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
        jnp.asarray(batch["depth_values"]),
    )
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    ours = state_dict_from_jax(params, stats)
    want = export_state_dict(params, stats)
    assert set(ours) == set(want), set(ours) ^ set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)

    port = MVSNet(ndepths=(8, 8, 8), depth_interval_ratio=(4, 2, 1))
    assert not any(k.endswith("num_batches_tracked") for k in ours)
    port.load_state_dict(ours, strict=True)
    load_reference_state_dict(port, {"module." + k: v for k, v in want.items()})
    for k, v in want.items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v, err_msg=k)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(port, {k: v for k, v in want.items() if "prob" not in k})


def _block_case(rng, jmod, x, ndim_in):
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    want = np.asarray(jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    # a one-block tree in the feature net's naming: feature.conv0.0.{conv,bn}
    sd = state_dict_from_jax({"feature": {"conv0_0": params}},
                             {"feature": {"conv0_0": stats}})
    sd = {k[len("feature.conv0.0."):]: v for k, v in sd.items()}
    perm = (0, ndim_in - 1, *range(1, ndim_in - 1))     # channels-last -> first
    inv = (0, *range(2, ndim_in), 1)
    return sd, torch.from_numpy(x.transpose(perm).copy()), want, inv


@pytest.mark.parametrize("dims", [2, 3])
def test_conv_and_deconv_blocks_match_jax(rng, dims):
    shape = (2, 6, 10, 4) if dims == 2 else (1, 4, 6, 8, 4)
    x = rng.normal(size=shape).astype(np.float32)
    cases = [
        (jblocks.ConvBlock(6, kernel=3, stride=1, dims=dims),
         tblocks.ConvBlock(4, 6, 3, 1, dims=dims)),
        (jblocks.ConvBlock(6, kernel=3, stride=2, dims=dims),
         tblocks.ConvBlock(4, 6, 3, 2, dims=dims)),
        (jblocks.DeconvBlock(5, kernel=3, dims=dims),
         tblocks.DeconvBlock(4, 5, 3, dims=dims)),
    ]
    for jmod, tmod in cases:
        sd, xt, want, inv = _block_case(rng, jmod, x, len(shape))
        load_reference_state_dict(tmod, sd)
        with torch.no_grad():
            got = tmod.eval()(xt).permute(*inv).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=0,
                                   err_msg=type(tmod).__name__)
