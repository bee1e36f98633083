"""``agg_mode="adaptive"`` of the port against the JAX package's
``MVSNet(agg_mode="adaptive")`` with identical weights (64x96, 3 views,
ndepths 8/8/8, interval ratios 4/2/1, inverse depth).

The weights start on the port's side (seeded init, random batch-norm
parameters and statistics, probability heads damped by 0.2 as in
tests/test_torch_train_step.py) and reach JAX through
``convert.jax_tree_from_state_dict``, whose ``agg_weight`` names are the
port's own (the reference never runs the module).  The file runs one
jitted JAX program of the whole model, which holds the eval forward (on the
batch the CLI's dataset loads) and the train-mode forward with its loss and
new batch statistics (on a synthetic training batch of 2); and the
adaptive cost pass alone under ``jax.grad``.

* eval through the CLI (``--agg_mode adaptive``, the test's weights via
  ``--resume``): depth <= 0.01 mm, confidence <= 1e-4;
* the train-mode forward: loss within 1e-5 relative, depth within 0.01 mm,
  and the new running statistics within 1e-4 * max(1, max|stat|), the
  weight nets' included: one net per (stage, pass) called once per source
  view, so its statistics take V-1 chained updates in one forward, as
  flax's do;
* the ``agg_weight`` names: JAX tree -> state dict -> JAX tree is bitwise
  (the JAX model ran on the converted tree, and its new batch statistics
  map back onto every running statistic of the port);
* the training CLI with ``--agg_mode adaptive``: one step, a checkpoint
  with the weight nets, which loads strictly into an adaptive model;
* the adaptive cost pass with a small linear gate: value and gradients
  (features and gate) against the JAX package's, 1e-4 absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.losses.mvs_loss import mvs_loss as j_mvs_loss
from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.convert import (jax_tree_from_state_dict, load_reference_state_dict,
                                       state_dict_from_jax)
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.utils import synthetic

H, W, V = 64, 96, 3
NDEPTHS, RATIOS, DLOSSW = (8, 8, 8), (4, 2, 1), (0.5, 1.0, 2.0)
DEPTH_TOL_MM, CONF_TOL, LOSS_RTOL, STAT_RTOL = 0.01, 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs beside other workers, where a
    process that spins a thread per core slows every one of them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _port_model() -> MVSNet:
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="cuda", agg_mode="adaptive")  # CPU tensors: plain version
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
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("adaptive")
    model = _port_model()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(sd0, root / "weights.pt")

    data = root / "data"
    synthetic.write_eval_scene(str(data), "scan1", height=H, width=W, n_views=V)
    summary = cli.main(["--test", "--preset", "dtu_test", "--device", "cpu",
                        "--datapath", str(data), "--testlist", "scan1", "--outdir",
                        str(root / "out"), "--ndepths", *map(str, NDEPTHS), "--max_h", str(H),
                        "--max_w", str(W), "--num_view", str(V), "--filter_method", "none",
                        "--agg_mode", "adaptive", "--resume", str(root / "weights.pt")])
    assert summary["maps"] == V
    pfm = [[io.read_pfm(str(root / "out" / "scan1" / kind / f"{i:08d}.pfm"))[0]
            for i in range(V)] for kind in ("depth_est", "confidence")]

    ds = GeneralEvalDataset(str(data), ["scan1"], nviews=V, ndepths=192, interval_scale=1.06,
                            max_h=H, max_w=W, inverse_depth=True)
    samples = [ds[i] for i in range(V)]
    ev = (np.stack([s["imgs"] for s in samples]),
          {k: np.stack([s["proj_matrices"][k] for s in samples])
           for k in samples[0]["proj_matrices"]},
          np.stack([s["depth_values"] for s in samples]))

    batch = synthetic.make_batch(batch=2, n_views=V, height=H, width=W, n_depths=32)
    rng = np.random.default_rng(0)
    batch["imgs"] = (batch["imgs"] + rng.normal(0, 0.02, batch["imgs"].shape)).astype(np.float32)
    batch["imgs"][1] = batch["imgs"][1, :, ::-1].copy()

    params, stats = jax_tree_from_state_dict(sd0)
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 agg_mode="adaptive")

    def both(variables, ev, tb):
        e = jm.apply(variables, *ev)
        t, mutated = jm.apply(variables, tb["imgs"], tb["proj_matrices"], tb["depth_values"],
                              train=True, mutable=["batch_stats"])
        loss = j_mvs_loss(t, tb["depth"], tb["mask"], "regression", DLOSSW)
        return (e["depth"], e["photometric_confidence"]), (t["depth"], loss,
                                                          mutated["batch_stats"])

    j_eval, j_train = jax.jit(both)({"params": params, "batch_stats": stats},
                                    jax.tree_util.tree_map(jnp.asarray, ev),
                                    jax.tree_util.tree_map(jnp.asarray, batch))
    j_eval, j_train = jax.tree_util.tree_map(np.asarray, (j_eval, j_train))

    tb = jax.tree_util.tree_map(torch.from_numpy, batch)
    model.train()
    with torch.no_grad():
        out = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
        loss = mvs_loss(out, tb["depth"], tb["mask"], "regression", DLOSSW)
    return dict(root=root, sd0=sd0, params=params, stats=stats, pfm=pfm,
                j_eval=j_eval, j_train=j_train, t_depth=out["depth"].numpy(),
                t_loss=float(loss), t_state=model.state_dict())


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_cli_eval_matches_jax(runs):
    depth, conf = (np.stack(m) for m in runs["pfm"])
    dd = _maxdiff(depth, runs["j_eval"][0])
    dc = _maxdiff(conf, runs["j_eval"][1])
    print(f"adaptive eval: depth max |diff| {dd:.3e} mm, confidence {dc:.3e}")
    assert np.isfinite(depth).all()
    assert dd <= DEPTH_TOL_MM and dc <= CONF_TOL


def test_train_mode_forward_matches_jax(runs):
    j_depth, j_loss, _ = runs["j_train"]
    rel = abs(runs["t_loss"] - float(j_loss)) / abs(float(j_loss))
    print(f"adaptive train-mode loss {runs['t_loss']:.6f} vs {float(j_loss):.6f} "
          f"(rel {rel:.2e}); depth max |diff| {_maxdiff(runs['t_depth'], j_depth):.3e} mm")
    assert np.isfinite(runs["t_loss"]) and rel <= LOSS_RTOL
    assert _maxdiff(runs["t_depth"], j_depth) <= DEPTH_TOL_MM


def test_chained_weight_net_statistics_match_jax(runs):
    want = state_dict_from_jax({}, runs["j_train"][2])
    got = runs["t_state"]
    assert sum(k.startswith("agg_weight") for k in want) == 2 * 2 * 2 * len(NDEPTHS)
    for name, w in want.items():
        tol = STAT_RTOL * max(1.0, float(w.abs().max()))
        assert float((got[name] - w).abs().max()) <= tol, name
        assert not torch.equal(got[name], runs["sd0"][name]), name
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == (V - 1 if k.startswith("agg_weight") else 1), k


def test_agg_weight_names_round_trip(runs):
    sd0 = runs["sd0"]
    params, stats = runs["params"], runs["stats"]
    tops = {k for k in params if k.startswith("agg_weight")}
    assert tops == {f"agg_weight_{s}{c}" for s in range(len(NDEPTHS)) for c in ("", "_c")}
    back = state_dict_from_jax(params, stats)
    assert set(back) == {k for k in sd0 if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, sd0[k]), k
    again = jax_tree_from_state_dict(back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, (params, stats))


def test_cli_trains_adaptive(tmp_path):
    data = tmp_path / "dtu"
    synthetic.write_dtu_training_tree(str(data), n_views=V, height=32, width=64)
    argv = ["--device", "cpu", "--datapath", str(data), "--trainlist", "scan1",
            "--testlist", "scan1", "--nviews", str(V), "--batch_size", "1", "--epochs", "1",
            "--ndepths", *map(str, NDEPTHS), "--numdepth", "16", "--img_size", "32", "64",
            "--max_train_samples", "1", "--max_val_samples", "1", "--agg_mode", "adaptive",
            "--log_dir", str(tmp_path / "logs")]
    summary = cli.main(argv)
    assert summary["step"] == 1
    epoch = summary["history"][0]
    assert all(np.isfinite(v) for v in epoch["train_avg"].values())
    saved = torch.load(epoch["checkpoint"], weights_only=True)["model"]
    assert {k.split(".")[0] for k in saved} >= {"agg_weight", "agg_weight_refine"}
    model = MVSNet(ndepths=NDEPTHS, agg_mode="adaptive")
    load_reference_state_dict(model, saved)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in saved.items())


def test_adaptive_cost_pass_gradient_matches_jax(rng):
    """The adaptive cost pass alone, with a gate of two weights and a bias:
    value and gradients (features, gate weights) of the kernel's wrapper (on
    CPU tensors its plain version per view pair) and of the plain
    ``ops.warp.aggregate_cost_volume_adaptive`` against ``jax.grad`` of the
    JAX package's ``aggregate_cost_volume_adaptive`` (its XLA path).
    Tolerance 1e-4 absolute on unit-variance features and cotangents."""
    from dmvsnet_tpu.ops import warp as jwarp
    from dmvsnet_tpu_torch.ops import warp as tw
    from dmvsnet_tpu_torch.ops import warp_correlate as wc

    b, h, w, c, d = 2, 16, 24, 8, 4
    feats = rng.normal(size=(b, V, h, w, c)).astype(np.float32)
    proj2 = np.stack([synthetic.camera_set("orbit", V, h, w)] * b).astype(np.float32)
    dv = rng.uniform(400, 900, (b, d, h, w)).astype(np.float32)
    cot = rng.normal(size=(b, d, h, w, 2)).astype(np.float32)
    gate = np.array([0.7, -1.3, 0.2], np.float32)

    def jloss(f, g):
        cost = jwarp.aggregate_cost_volume_adaptive(
            [f[:, i] for i in range(V)], jnp.asarray(proj2), jnp.asarray(dv),
            lambda sim: sim @ g[:2, None] + g[2])
        return jnp.sum(cost * jnp.asarray(cot)), cost

    (_, want), (want_f, want_g) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(
        jnp.asarray(feats), jnp.asarray(gate))
    for name in ("kernel wrapper", "plain"):
        f, g = torch.from_numpy(feats).requires_grad_(), torch.from_numpy(gate).requires_grad_()
        args = (torch.from_numpy(proj2), torch.from_numpy(dv))

        def logits(sim):
            return sim @ g[:2, None] + g[2]

        got = (wc.aggregate_cost_volume_adaptive(
                   f, *args, lambda sim: sim * torch.sigmoid(logits(sim)))
               if name == "kernel wrapper"
               else tw.aggregate_cost_volume_adaptive(list(f.unbind(1)), *args, logits))
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_f), atol=1e-4, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_g), atol=1e-4, rtol=1e-5,
                                   err_msg=name)
