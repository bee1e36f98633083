"""The port's losses and metrics vs the JAX package on the same numpy inputs.

Tolerances: relative 1e-5 on scalar losses (fp32 reductions over a few
thousand elements in another order), 1e-6 absolute on metrics.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvsnet_tpu.losses import alt_losses as jalt
from dmvsnet_tpu.losses import metrics as jmetrics
from dmvsnet_tpu_torch.losses import alt_losses as talt
from dmvsnet_tpu_torch.losses import metrics as tmetrics

# both packages re-export the function mvs_loss under the module's name
jloss = importlib.import_module("dmvsnet_tpu.losses.mvs_loss")
tloss = importlib.import_module("dmvsnet_tpu_torch.losses.mvs_loss")

RTOL = 1e-5
METRIC_ATOL = 1e-6


def _stage_outputs(rng, b=2, sizes=((8, 12), (16, 24), (32, 48)), d=8):
    """Random per-stage model outputs around GT depths of ~600 mm, with a
    mask that has holes, as {"stage{i}": {...}} numpy dicts."""
    outputs, gt, mask = {}, {}, {}
    for i, (h, w) in enumerate(sizes, start=1):
        key = f"stage{i}"
        gt[key] = rng.uniform(500, 700, (b, h, w)).astype(np.float32)
        mask[key] = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
        dv = np.sort(rng.uniform(450, 750, (b, d, h, w)).astype(np.float32), axis=1)
        prob = rng.uniform(0.01, 1.0, (b, d, h, w, 4)).astype(np.float32)
        outputs[key] = {
            "depth_sub_plus": (gt[key][..., None]
                               + rng.normal(0, 3.0, (b, h, w, 4))).astype(np.float32),
            "depth_sub_plus_refine": (gt[key][..., None]
                                      + rng.normal(0, 0.7, (b, h, w, 4))).astype(np.float32),
            "prob_volume": prob / prob.sum(1, keepdims=True),
            "depth_values": dv,
            "interval": np.float32(4.0 / i),
        }
    return outputs, gt, mask


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _both(rng, **kw):
    outputs, gt, mask = _stage_outputs(rng, **kw)
    j = tuple(_to(t, jnp.asarray) for t in (outputs, gt, mask))
    t = tuple(_to(t, lambda v: torch.from_numpy(np.asarray(v))) for t in (outputs, gt, mask))
    return j, t


def test_mvs_loss_matches_jax(rng):
    j, t = _both(rng)
    want = float(jloss.mvs_loss(*j))
    got = float(tloss.mvs_loss(*t))
    assert np.isfinite(got) and abs(got - want) <= RTOL * abs(want)
    # stage weights enter linearly
    want2 = float(jloss.mvs_loss(*j, dlossw=(1.0, 0.25, 3.0)))
    got2 = float(tloss.mvs_loss(*t, dlossw=(1.0, 0.25, 3.0)))
    assert abs(got2 - want2) <= RTOL * abs(want2) and abs(got2 - got) > 1.0


def test_mvs_loss_gradient_matches_jax(rng):
    """d loss / d depth_sub_plus of stage 3 (min/max composites, the
    checkerboard and the half-pixel pools all carry gradient)."""
    (jo, jg, jm), (to, tg, tm) = _both(rng)

    def jfn(x):
        outs = {**jo, "stage3": {**jo["stage3"], "depth_sub_plus": x}}
        return jloss.mvs_loss(outs, jg, jm)

    want = np.asarray(jax.grad(jfn)(jo["stage3"]["depth_sub_plus"]))
    x = to["stage3"]["depth_sub_plus"].clone().requires_grad_()
    tloss.mvs_loss({**to, "stage3": {**to["stage3"], "depth_sub_plus": x}}, tg, tm).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-7, rtol=1e-4)


def test_empty_mask_gives_zero_not_nan(rng):
    (jo, jg, jm), (to, tg, tm) = _both(rng)
    got = tloss.mvs_loss(to, tg, _to(tm, torch.zeros_like))
    assert float(got) == 0.0 == float(jloss.mvs_loss(jo, jg, _to(jm, jnp.zeros_like)))
    empty = torch.zeros(2, 8, 12)
    m = tmetrics.standard_metrics(torch.ones(2, 8, 12), torch.zeros(2, 8, 12), empty)
    assert all(float(v) == 0.0 for v in m.values())
    for mode in ("classification", "gfocal", "unification"):
        val = float(talt.alt_mvs_loss(to, tg, _to(tm, torch.zeros_like), mode, (0.5, 1.0, 2.0)))
        assert val == 0.0, mode


@pytest.mark.parametrize("mode,reflect", [("center", False), ("center", True),
                                          ("random", False), ("random", True)])
def test_monte_carlo_loss_matches_jax(rng, mode, reflect):
    b, h, w = 2, 16, 24
    gt = rng.uniform(500, 700, (b, h, w)).astype(np.float32)
    est = (gt + rng.normal(0, 1.5, gt.shape)).astype(np.float32)
    mask = (rng.uniform(size=gt.shape) > 0.2).astype(np.float32)
    weight = np.full_like(gt, 2.0)
    key = jax.random.PRNGKey(7)
    want = float(jloss.monte_carlo_loss(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask),
                                        jnp.asarray(weight), mode=mode, reflect=reflect,
                                        rng=key if mode == "random" else None))
    offsets = None
    if mode == "random":
        # the offsets the JAX function draws from this key, handed over as numpy
        kx, ky = jax.random.split(key)
        shape = (b, h - 1, w - 1)
        offsets = tuple(torch.from_numpy(np.array(jax.random.uniform(k, shape, jnp.float32)))
                        for k in (kx, ky))
    args = tuple(torch.from_numpy(a) for a in (est, gt, mask, weight))
    got = float(tloss.monte_carlo_loss(*args, mode=mode, reflect=reflect, offsets=offsets))
    assert want > 0 and abs(got - want) <= RTOL * abs(want)


def test_monte_carlo_random_takes_an_explicit_generator(rng):
    gt = torch.from_numpy(rng.uniform(500, 700, (1, 8, 8)).astype(np.float32))
    est, mask, weight = gt + 1.0, torch.ones_like(gt), torch.ones_like(gt)
    with pytest.raises(ValueError, match="Generator"):
        tloss.monte_carlo_loss(est, gt, mask, weight, mode="random")
    with pytest.raises(ValueError, match="unknown"):
        tloss.monte_carlo_loss(est, gt, mask, weight, mode="corner")
    a = tloss.monte_carlo_loss(est, gt, mask, weight, mode="random",
                               generator=torch.Generator().manual_seed(3))
    b = tloss.monte_carlo_loss(est, gt, mask, weight, mode="random",
                               generator=torch.Generator().manual_seed(3))
    # est - gt == 1 everywhere: every sub-pixel sample has error 1, smooth-L1 0.5
    assert float(a) == float(b) and abs(float(a) - 0.5) < 1e-4


@pytest.mark.parametrize("mode", ["classification", "gfocal", "unification"])
def test_alternate_losses_match_jax(rng, mode):
    (jo, jg, jm), (to, tg, tm) = _both(rng)
    want = float(jloss.mvs_loss(jo, jg, jm, mode=mode))
    got = float(tloss.mvs_loss(to, tg, tm, mode=mode))
    assert np.isfinite(want) and want != 0.0
    assert abs(got - want) <= RTOL * abs(want)


def test_entropy_loss_and_unknown_mode(rng):
    (jo, jg, jm), (to, tg, tm) = _both(rng)
    s = "stage2"
    want = float(jalt.entropy_loss(jo[s]["prob_volume"][..., 0], jg[s], jm[s],
                                   jo[s]["depth_values"]))
    got = float(talt.entropy_loss(to[s]["prob_volume"][..., 0], tg[s], tm[s],
                                  to[s]["depth_values"]))
    assert abs(got - want) <= RTOL * abs(want)
    with pytest.raises(NotImplementedError):
        tloss.mvs_loss(to, tg, tm, mode="focal")


def test_standard_metrics_match_jax(rng):
    b, h, w = 3, 16, 24
    gt = rng.uniform(500, 700, (b, h, w)).astype(np.float32)
    est = (gt + rng.normal(0, 4.0, gt.shape)).astype(np.float32)
    mask = rng.uniform(size=gt.shape) > 0.4
    mask[1] = False  # one image with an empty mask contributes 0
    want = jmetrics.standard_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask))
    got = tmetrics.standard_metrics(torch.from_numpy(est), torch.from_numpy(gt),
                                    torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= METRIC_ATOL, k
    assert 0.0 < float(got["thres8mm_error"]) < float(got["thres2mm_error"]) < 1.0
