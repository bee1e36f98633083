"""The port's FeatureNet, cost U-Nets and depth heads vs the JAX package,
with identical weights (random batch-norm statistics) bridged by
dmvsnet_tpu_torch.convert.

* FeatureNet on B*V = 8 images in one call matches the JAX MVSNet's
  chunked eval feature extraction (chunks of at most 6 images; exact
  because eval batch norm uses running statistics);
* CostRegNet / CostRegNetRefine match (the JAX level-0 runs in its folded
  layout over the same parameters);
* depth_net.forward / refine match on random cost volumes.

Tolerances: features and regularized costs 1e-4 absolute (fp32 conv
reassociation over 11-15 layers); depths 1e-3 mm at ~600 mm (fp32 soft
argmax); confidences 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu.models import cost_reg as jcr
from dmvsnet_tpu.models import depth_net as jdn
from dmvsnet_tpu.models.feature_net import FeatureNet as JFeatureNet
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch.convert import load_reference_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.models import cost_reg as tcr
from dmvsnet_tpu_torch.models import depth_net as tdn
from dmvsnet_tpu_torch.models.feature_net import FeatureNet

FEAT_TOL = 1e-4
DEPTH_TOL_MM = 1e-3
CONF_TOL = 1e-5


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


def _sub_state_dict(params, stats, top, prefix):
    sd = state_dict_from_jax({top: params}, {top: stats})
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_feature_net_matches_jax_chunked_eval(rng):
    b, v, h, w = 2, 4, 64, 96
    batch = jsyn.make_batch(batch=b, n_views=v, height=h, width=w, n_depths=8)
    imgs = (batch["imgs"] + rng.normal(0, 0.05, batch["imgs"].shape)).astype(np.float32)
    # stop after stage-1 sampling: only the feature net runs
    jm = JMVSNet(ndepths=(8, 8, 8), depth_interval_ratio=(4, 2, 1), run_stages=0.2)
    args = (jnp.asarray(imgs), {k: jnp.asarray(x) for k, x in batch["proj_matrices"].items()},
            jnp.asarray(batch["depth_values"]))
    variables = jm.init(jax.random.PRNGKey(0), *args)
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    _, state = jm.apply({"params": params, "batch_stats": stats}, *args,
                        capture_intermediates=lambda mdl, _: isinstance(mdl, JFeatureNet),
                        mutable=["intermediates"])
    chunks = state["intermediates"]["feature"]["__call__"]
    assert len(chunks) == 2  # 8 images -> 4 + 4
    want = {k: np.concatenate([np.asarray(c[k]) for c in chunks]) for k in chunks[0]}

    fnet = FeatureNet()
    load_reference_state_dict(fnet, _sub_state_dict(params["feature"], stats["feature"],
                                                    "feature", "feature."))
    with torch.no_grad():
        got = fnet.eval()(torch.from_numpy(imgs.reshape(b * v, h, w, 3)).permute(0, 3, 1, 2))
    for k in ("stage1", "stage1_c", "stage2", "stage2_c", "stage3", "stage3_c"):
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[k].shape, k
        np.testing.assert_allclose(g, want[k], atol=FEAT_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("refine", [False, True])
def test_cost_reg_nets_match_jax(rng, refine):
    d = 4 if refine else 8
    x = rng.normal(size=(1, d, 16, 24, 2)).astype(np.float32)
    jcls, tcls = ((jcr.CostRegNetRefine, tcr.CostRegNetRefine) if refine
                  else (jcr.CostRegNet, tcr.CostRegNet))
    jm = jcls(8)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    top = "cost_reg_refine_0" if refine else "cost_reg_0"
    prefix = ("cost_regularization_refine.0." if refine else "cost_regularization.0.")
    tm = tcls(8)
    load_reference_state_dict(tm, _sub_state_dict(params, stats, top, prefix))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape == (1, d, 16, 24, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=FEAT_TOL, rtol=0)


def test_depth_heads_match_jax(rng):
    b, d, h, w = 2, 8, 8, 12
    cost = rng.normal(0, 2.0, (b, d, h, w, 4)).astype(np.float32)
    dv = np.sort(rng.uniform(500, 700, (b, d, h, w)).astype(np.float32), axis=1)
    interval = np.float32(3.5)
    jo = jdn.forward(jnp.asarray(cost), jnp.asarray(dv), jnp.asarray(interval))
    to = tdn.forward(torch.from_numpy(cost), torch.from_numpy(dv), torch.tensor(interval))
    np.testing.assert_allclose(to["prob_volume"].numpy(), np.asarray(jo["prob_volume"]),
                               atol=1e-6)
    for k in ("depth_sub_plus", "depth_values_c"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=DEPTH_TOL_MM,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(to["photometric_confidence"].numpy(),
                               np.asarray(jo["photometric_confidence"]), atol=CONF_TOL)

    cost_c = rng.normal(0, 1.0, (b, 4, h, w, 4)).astype(np.float32)
    dv_c = np.array(jo["depth_values_c"])
    jr = jdn.refine(jnp.asarray(cost_c), jnp.asarray(dv_c), jnp.asarray(interval))
    tr = tdn.refine(torch.from_numpy(cost_c), torch.from_numpy(dv_c), torch.tensor(interval))
    for k in ("depth", "depth_sub_plus_refine"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=DEPTH_TOL_MM,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(tr["photometric_confidence_refine"].numpy(),
                               np.asarray(jr["photometric_confidence_refine"]), atol=CONF_TOL)
