"""The port's BlendedMVS dataset and fine-tuning recipe on the CPU: the copy
of dmvsnet_tpu.data.blendedmvs against the JAX package's on a synthetic
BlendedMVS tree (utils/synthetic.write_blendedmvs_tree), samples equal
array for array with the same seed, train-mode augmentation included; and
the blendedmvs_finetune preset through the CLI, resuming a DTU checkpoint's
weights alone.
"""

import os

import numpy as np
import pytest
import torch

from dmvsnet_tpu.data import loader as jloader
from dmvsnet_tpu.data.blendedmvs import BlendedMVSDataset as JBlendedMVSDataset
from dmvsnet_tpu.data.blendedmvs import color_jitter as jcolor_jitter
from dmvsnet_tpu.data.blendedmvs import motion_blur as jmotion_blur
from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.data import loader as tloader
from dmvsnet_tpu_torch.data.blendedmvs import BlendedMVSDataset, color_jitter, motion_blur
from dmvsnet_tpu_torch.engine import checkpoint as ckpt_lib
from dmvsnet_tpu_torch.engine.train import Trainer, build_model
from dmvsnet_tpu_torch.utils import synthetic

SCAN = "synthetic_plane"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blendedmvs"))
    synthetic.write_blendedmvs_tree(root, SCAN, n_views=4, height=64, width=96, ndepths=16)
    return root


def check(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            check(a[k], b[k])
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_tree_has_the_blendedmvs_layout(tree):
    scan = os.path.join(tree, SCAN)
    assert sorted(os.listdir(scan)) == ["blended_images", "cams", "rendered_depth_maps"]
    assert sorted(os.listdir(os.path.join(scan, "cams")))[-1] == "pair.txt"
    ds = BlendedMVSDataset(tree, [SCAN], nviews=4, ndepths=16, mode="val")
    s = ds[0]
    assert len(ds) == 4 and s["imgs"].shape == (4, 64, 96, 3)
    # full-resolution intrinsics: the pyramid scales 1/4, 1/2, 1
    assert s["proj_matrices"]["stage3"][0, 1, 0, 0] == pytest.approx(1.2 * 96)
    assert s["proj_matrices"]["stage1"][0, 1, 0, 0] == pytest.approx(0.3 * 96)
    assert s["depth"]["stage1"].shape == (16, 24) and (s["mask"]["stage3"] == 1).all()
    np.testing.assert_allclose(s["depth"]["stage3"], 600.0)
    assert s["depth_values"][0] == 500.0 and s["depth_values"][-1] > 600.0


@pytest.mark.parametrize("mode", ["train", "val"])
def test_samples_equal_the_jax_dataset(tree, mode):
    """Same seed, same samples in the same order: the train mode's colour
    jitter and motion blur draw from one generator in both packages."""
    kw = dict(nviews=3, ndepths=16, interval_scale=1.06, mode=mode, seed=5)
    ours, theirs = BlendedMVSDataset(tree, [SCAN], **kw), JBlendedMVSDataset(tree, [SCAN], **kw)
    assert ours.metas == theirs.metas and len(ours) == 4
    for i in (0, 3, 1, 0):
        check(ours[i], theirs[i])
    plain = BlendedMVSDataset(tree, [SCAN], **dict(kw, mode="val"))[0]["imgs"]
    assert (mode == "train") == (not np.array_equal(ours[0]["imgs"], plain))


def test_augmentations_equal_the_jax_ones(rng):
    img = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    for seed in range(6):
        ours = motion_blur(color_jitter(img, np.random.default_rng(seed)),
                           np.random.default_rng(seed + 10))
        theirs = jmotion_blur(jcolor_jitter(img, np.random.default_rng(seed)),
                              np.random.default_rng(seed + 10))
        np.testing.assert_array_equal(ours, theirs)


def test_loaders_build_the_same_blendedmvs_batches(tree):
    ours = tloader.get_dataset("blendedmvs", tree, [SCAN], 3, "val", ndepths=16)
    theirs = jloader.get_dataset("blendedmvs", tree, [SCAN], 3, "val", ndepths=16)
    assert isinstance(ours, BlendedMVSDataset)
    a = tloader.make_loader(ours, 2, "val", seed=0, num_hosts=1, host_id=0, workers=1)
    b = jloader.make_loader(theirs, 2, "val", seed=0, num_hosts=1, host_id=0, workers=1)
    batches = list(zip(a, b))
    assert len(batches) == 2
    for x, y in batches:
        check(x, y)


def test_finetune_recipe_resumes_weights_only_through_the_cli(tree, tmp_path):
    """--preset blendedmvs_finetune at a toy size: the DTU checkpoint's
    weights load (its optimizer state and epoch do not), then one step."""
    dtu = preset("dtu_train", ndepths=(8, 8, 8), seed=3)
    model = build_model(dtu, torch.device("cpu"))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    ckpt = ckpt_lib.save_checkpoint(str(tmp_path / "dtu"), 7, model, opt, sched)
    argv = ["--preset", "blendedmvs_finetune", "--device", "cpu", "--datapath", tree,
            "--trainlist", f"scans:{SCAN}", "--testlist", f"scans:{SCAN}",
            "--log_dir", str(tmp_path / "logs"), "--resume", ckpt, "--ndepths", "8", "8", "8",
            "--numdepth", "16", "--nviews", "3", "--epochs", "1", "--max_train_samples", "1",
            "--max_val_samples", "1", "--summary_freq", "1"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.dataset_name == "blendedmvs" and cfg.blendedmvs_finetune and cfg.lr == 1e-4
    trainer = Trainer(cfg, device="cpu")
    assert trainer.start_epoch == 0 and trainer.step == 0
    saved = model.state_dict()
    assert all(torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items())
    summary = cli.main(argv)
    assert summary["step"] == 1 and summary["mode"] == "train"
    epoch = summary["history"][0]
    assert epoch["epoch"] == 0 and os.path.exists(epoch["checkpoint"])
    for avg in (epoch["train_avg"], epoch["val_avg"]):
        assert all(np.isfinite(v) for v in avg.values()), avg
