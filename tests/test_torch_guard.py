"""Rules of the port that hold whatever the numbers:

* no module of dmvsnet_tpu_torch imports jax, flax, optax, orbax or the
  dmvsnet_tpu package (an ast walk over every source file);
* entry points run on CUDA unless told otherwise, and raise on a machine
  without CUDA instead of carrying on on the CPU;
* options the port does not run yet raise and name the ROADMAP item;
* the CLI's --test path writes depth maps on --device cpu, its default mode
  is training, and --vis still errors;
* the seeded initialisation depends on the seed alone.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import dmvsnet_tpu_torch
from dmvsnet_tpu_torch import cli, resolve_device
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.loader import get_dataset
from dmvsnet_tpu_torch.engine.evaluate import build_model, run_test
from dmvsnet_tpu_torch.engine.train import Trainer
from dmvsnet_tpu_torch.engine.train import build_model as build_train_model
from dmvsnet_tpu_torch.utils import synthetic

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dmvsnet_tpu"}
PORT_ROOT = Path(dmvsnet_tpu_torch.__file__).parent


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT_ROOT.rglob("*.py"))
    assert len(files) > 25
    names = {str(f.relative_to(PORT_ROOT)) for f in files}
    # the training slice's modules are under the walk
    assert {"losses/mvs_loss.py", "losses/metrics.py", "losses/alt_losses.py",
            "engine/state.py", "engine/steps.py", "engine/checkpoint.py", "engine/train.py",
            "engine/imagery.py", "data/dtu.py", "data/loader.py"} <= names
    bad = [f"{f.relative_to(PORT_ROOT)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad
    # the walk itself sees the allowed package name as distinct
    assert "dmvsnet_tpu_torch" not in FORBIDDEN


@pytest.fixture
def scene(tmp_path):
    synthetic.write_eval_scene(str(tmp_path / "data"), "scan1", height=64, width=96,
                               n_views=3)
    return tmp_path


def _cfg(scene, **kw):
    return preset("dtu_test", datapath=str(scene / "data"), testlist="scan1",
                  outdir=str(scene / "out"), ndepths=(8, 8, 8), max_h=64, max_w=96,
                  num_view=3, filter_method="none", **kw)


def test_entry_points_default_to_cuda_and_raise_without_it(scene):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        run_test(_cfg(scene))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--test", "--preset", "dtu_test", "--datapath", str(scene / "data"),
                  "--testlist", "scan1", "--filter_method", "none"])
    assert not os.path.exists(scene / "out")
    assert resolve_device("cpu") == torch.device("cpu")
    # training: the Trainer and the CLI's default mode want the card too
    train_cfg = preset("dtu_train", datapath=str(scene / "data"), log_dir=str(scene / "logs"))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(train_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--preset", "dtu_train", "--datapath", str(scene / "data"),
                  "--log_dir", str(scene / "logs")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--val", "--preset", "dtu_train", "--datapath", str(scene / "data")])
    assert not os.path.exists(scene / "logs")


def test_unported_options_raise(scene):
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="epipolar"):
        build_model(_cfg(scene, warp_impl="epipolar"), cpu)
    with pytest.raises(NotImplementedError, match="adaptive"):
        build_model(_cfg(scene, agg_mode="adaptive"), cpu)
    with pytest.raises(NotImplementedError, match="fp32"):
        build_model(_cfg(scene, costreg_dtype="bfloat16"), cpu)
    with pytest.raises(ValueError, match="CUDA device"):
        build_model(_cfg(scene, warp_impl="cuda"), cpu)
    for method in ("pcd", "dypcd"):
        with pytest.raises(NotImplementedError, match="fusion"):
            run_test(_cfg(scene).replace(filter_method=method), device="cpu")
    assert build_model(_cfg(scene), cpu).warp_impl == "torch"
    # training options that wait for later slices
    train_cfg = preset("dtu_train", datapath=str(scene / "data"))
    with pytest.raises(NotImplementedError, match="remat"):
        build_train_model(train_cfg.replace(remat=True), cpu)
    with pytest.raises(NotImplementedError, match="fp32 only"):
        build_train_model(train_cfg.replace(compute_dtype="bfloat16"), cpu)
    with pytest.raises(NotImplementedError, match="blendedmvs"):
        get_dataset("blendedmvs", str(scene / "data"), ["scan1"], 5, "train")
    with pytest.raises(NotImplementedError, match="adaptive"):
        build_train_model(train_cfg.replace(agg_mode="adaptive"), cpu)
    model = build_train_model(train_cfg, cpu)
    assert model.training and model.warp_impl == "torch"
    assert not build_model(_cfg(scene), cpu).training


def test_cli_test_path_on_cpu(scene):
    summary = cli.main([
        "--test", "--preset", "dtu_test", "--device", "cpu",
        "--datapath", str(scene / "data"), "--testlist", "scan1",
        "--outdir", str(scene / "out"), "--ndepths", "8", "8", "8",
        "--max_h", "64", "--max_w", "96", "--num_view", "3", "--filter_method", "none",
    ])
    assert summary["maps"] == 3 and summary["device"] == "cpu"
    depth, _ = io.read_pfm(str(scene / "out/scan1/depth_est/00000001.pfm"))
    conf, _ = io.read_pfm(str(scene / "out/scan1/confidence/00000001.pfm"))
    assert depth.shape == conf.shape == (64, 96)
    assert np.isfinite(depth).all() and np.isfinite(conf).all()
    with pytest.raises(SystemExit):
        cli.main(["--vis", "--device", "cpu"])  # visualisation is not ported
    # without a mode flag the CLI trains: on the eval scene it gets as far as
    # looking for the DTU training tree
    with pytest.raises(FileNotFoundError, match="pair.txt"):
        cli.main(["--preset", "dtu_train", "--device", "cpu", "--datapath",
                  str(scene / "data"), "--trainlist", "scan1", "--testlist", "scan1"])


def test_seeded_init_depends_on_the_seed_alone(scene):
    cpu = torch.device("cpu")
    a = build_model(_cfg(scene, seed=3), cpu).state_dict()
    b = build_model(_cfg(scene, seed=3), cpu).state_dict()
    c = build_model(_cfg(scene, seed=4), cpu).state_dict()
    w = "feature.conv0.0.conv.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["cost_regularization.1.cosR_huge.conv3.bn.running_var"] == 1.0)
