"""The port's Trainer on a synthetic on-disk DTU tree (CPU): the protocol of
tests/test_trainer.py (epoch loop, checkpoint, validation, full-state
resume), the data pipeline against the JAX package's arrays (exact), and
the way back of a trained checkpoint into the JAX package's naming.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvsnet_tpu.data import loader as jloader
from dmvsnet_tpu.data.dtu import DTUTrainDataset as JDTUTrainDataset
from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.convert import jax_tree_from_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.data import loader as tloader
from dmvsnet_tpu_torch.data.dtu import DTUTrainDataset
from dmvsnet_tpu_torch.engine import checkpoint as ckpt_lib
from dmvsnet_tpu_torch.engine.train import AverageMeter, Trainer
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    synthetic.write_dtu_training_tree(root, scans=("scan1",), n_views=3, height=64, width=160)
    return root


def _config(root, tmp, **kw):
    return Config(
        datapath=root, log_dir=os.path.join(tmp, "logs"),
        trainlist="scan1", testlist="scan1",
        dataset_name="dtu_yao", nviews=3, batch_size=1, epochs=1,
        ndepths=(8, 8, 8), interval_ratio=(4, 2, 1), numdepth=16,
        eval_freq=10, summary_freq=1000, img_size=(64, 160),
        max_train_samples=2, max_val_samples=1,
    ).replace(**kw)


@pytest.fixture(scope="module")
def trained(dtu_tree, tmp_path_factory):
    cfg = _config(dtu_tree, str(tmp_path_factory.mktemp("run")))
    trainer = Trainer(cfg, device="cpu")
    history = trainer.train()
    return cfg, trainer, history


def test_trainer_epoch_checkpoint_resume(trained):
    cfg, trainer, history = trained
    assert len(trainer.train_ds.metas) == 2
    assert len(trainer.val_ds.metas) == 1
    assert trainer.device.type == "cpu" and trainer.model.warp_impl == "torch"
    assert trainer.step == 2 and len(history) == 1
    assert all(np.isfinite(v) for v in history[0]["train_avg"].values())
    # the mean lr of the two warmup steps: schedule(0) and schedule(1)
    assert history[0]["train_avg"]["lr"] == pytest.approx(
        (trainer.lr_schedule(0) + trainer.lr_schedule(1)) / 2)

    # checkpoint written for epoch 0
    latest = ckpt_lib.latest_checkpoint(cfg.log_dir)
    assert latest is not None and latest.endswith("model_000000.ckpt")
    assert latest == history[0]["checkpoint"]

    # validation runs and produces finite scalars (epoch 0 of 1: it also ran
    # inside train())
    assert history[0]["val_avg"] is not None
    scalars = trainer.validate(0)
    assert np.isfinite(scalars["loss"])

    # resume: a fresh trainer restores epoch + optimizer state + weights
    trainer2 = Trainer(cfg.replace(resume=latest), device="cpu")
    assert trainer2.start_epoch == 1
    assert trainer2.step == trainer.step == 2
    steps = {int(s["step"]) for s in trainer2.optimizer.state_dict()["state"].values()}
    assert steps == {2}
    assert trainer2.scheduler.get_last_lr()[0] == pytest.approx(trainer.lr_schedule(2))
    sd, sd2 = trainer.model.state_dict(), trainer2.model.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    m, m2 = (t.optimizer.state_dict()["state"][0]["exp_avg"] for t in (trainer, trainer2))
    assert torch.equal(m, m2)

    # weights-only restore (val / test / finetune) leaves epoch and step alone
    trainer3 = Trainer(cfg.replace(resume=latest, blendedmvs_finetune=True), device="cpu")
    assert trainer3.start_epoch == 0 and trainer3.step == 0
    assert all(torch.equal(sd[k], v) for k, v in trainer3.model.state_dict().items())


def test_cli_val_mode_and_weight_files(trained, tmp_path):
    cfg, trainer, _ = trained
    latest = ckpt_lib.latest_checkpoint(cfg.log_dir)
    summary = cli.main([
        "--val", "--device", "cpu", "--datapath", cfg.datapath, "--resume", latest,
        "--log_dir", str(tmp_path / "logs"), "--trainlist", "scan1", "--testlist", "scan1",
        "--nviews", "3", "--batch_size", "1", "--ndepths", "8", "8", "8", "--numdepth", "16",
        "--img_size", "64", "160", "--max_train_samples", "2", "--max_val_samples", "1"])
    assert summary["mode"] == "val" and summary["device"] == "cpu" and summary["step"] == 2
    assert summary["val_avg"]["loss"] == pytest.approx(trainer.validate(0)["loss"], rel=1e-5)

    path = str(tmp_path / "weights" / "w.pt")
    ckpt_lib.save_weights(path, trainer.model)
    fresh = Trainer(cfg.replace(seed=5), device="cpu")
    key = "feature.conv0.0.conv.weight"
    assert not torch.equal(fresh.model.state_dict()[key], trainer.model.state_dict()[key])
    for source in (path, latest):  # a weights file, or the weights of a full checkpoint
        ckpt_lib.restore_weights(source, fresh.model)
        assert torch.equal(fresh.model.state_dict()[key], trainer.model.state_dict()[key])
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_trained_checkpoint_goes_back_to_the_jax_naming(trained):
    """jax_tree_from_state_dict (numpy in, numpy out) equals the JAX
    package's own converter on a checkpoint the port trained, matches the
    JAX model's parameter tree, and inverts state_dict_from_jax."""
    cfg, _, _ = trained
    payload = torch.load(ckpt_lib.latest_checkpoint(cfg.log_dir), weights_only=True)
    assert set(payload) == {"epoch", "step", "model", "optimizer", "lr_scheduler"}
    assert payload["epoch"] == 0 and payload["step"] == 2
    sd = {k: v.numpy() for k, v in payload["model"].items()}
    params, stats = jax_tree_from_state_dict(sd)
    want_p, want_s = convert_state_dict(sd)
    for got, want in ((params, want_p), (stats, want_s)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)

    batch = synthetic.make_batch(batch=1, n_views=3, height=64, width=96, n_depths=16)
    jm = JMVSNet(ndepths=(8, 8, 8), depth_interval_ratio=(4, 2, 1))
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
        jnp.asarray(batch["depth_values"]))
    for got, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(
            lambda s: tuple(s.shape), dict(want))

    back = state_dict_from_jax(params, stats)
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in back)
    with pytest.raises(KeyError):
        jax_tree_from_state_dict({"head.weight": np.zeros((2, 2, 1, 1), np.float32)})


def test_dtu_sample_and_epoch_order_equal_the_jax_package(dtu_tree, tmp_path):
    kw = dict(nviews=3, ndepths=16, interval_scale=1.06, img_size=(64, 160))
    ours = DTUTrainDataset(dtu_tree, ["scan1"], mode="train", **kw)
    theirs = JDTUTrainDataset(dtu_tree, ["scan1"], mode="train", **kw)
    assert len(ours) == len(theirs) == 3 * 7 and ours.metas == theirs.metas

    def check(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                check(a[k], b[k])
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    check(ours[4], theirs[4])
    sample = ours[4]
    assert sample["imgs"].shape == (3, 64, 160, 3)
    assert sample["depth"]["stage1"].shape == (16, 40)

    # the loader: same epoch order, batches and wrap-padding, for one host
    # and for host 1 of 2 (the JAX loader takes the same explicit arguments)
    for hosts, host in ((1, 0), (2, 1)):
        for mode in ("train", "val"):
            a = tloader.make_loader(ours, 4, mode, seed=3, num_hosts=hosts, host_id=host)
            b = jloader.make_loader(theirs, 4, mode, seed=3, num_hosts=hosts, host_id=host)
            for epoch in (0, 2):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert len(a) == len(b)
                np.testing.assert_array_equal(a._host_indices(), b._host_indices())
    a, b = (m.make_loader(ds, 2, "val", seed=0, num_hosts=1, host_id=0, workers=1)
            for m, ds in ((tloader, ours), (jloader, theirs)))
    a.dataset.metas, b.dataset.metas = ours.metas[:3], theirs.metas[:3]
    batches_a, batches_b = list(a), list(b)
    assert len(batches_a) == len(batches_b) == 2  # 3 samples, the last batch wrap-padded
    for x, y in zip(batches_a, batches_b):
        check(x, y)
    assert tloader.Loader(ours, 2, shuffle=False).num_hosts == 1  # one host by default
    # the factory's other datasets: blendedmvs builds as the JAX package's
    # does (samples held in tests/test_torch_blendedmvs.py)
    bmvs = str(tmp_path / "blendedmvs")
    synthetic.write_blendedmvs_tree(bmvs, "scene", n_views=3, height=32, width=64, ndepths=8)
    a, b = (m.get_dataset("blendedmvs", bmvs, ["scene"], 3, "train", ndepths=8, seed=1)
            for m in (tloader, jloader))
    assert type(a).__name__ == type(b).__name__ == "BlendedMVSDataset"
    check(a[2], b[2])


def test_average_meter_accumulates_without_reading(rng):
    meter = AverageMeter()
    assert meter.avg == {}
    for v in (1.0, 2.0, 6.0):
        meter.update({"loss": torch.tensor(v), "lr": v / 10})
    assert isinstance(meter.sums["loss"], torch.Tensor)  # still a tensor: no host read
    assert meter.avg == {"loss": pytest.approx(3.0), "lr": pytest.approx(0.3)}
