"""Rules of the port that hold whatever the numbers:

* no module of dmvsnet_tpu_torch, no scripts/torch_* file and not
  chip_smoke.py imports jax, flax, optax, orbax or the dmvsnet_tpu package
  (an ast walk over every source file);
* the torch launchers scripts/torch_*.sh parse and run the port's CLI at
  their recipe's preset;
* entry points run on CUDA unless told otherwise, and raise on a machine
  without CUDA instead of carrying on on the CPU;
* options the port does not run yet raise and name the ROADMAP item, and a
  filter_method no package implements raises;
* the dmvsnet-torch console script returns None (exit status 0) after a
  successful run;
* the CLI's --test path writes depth maps on --device cpu, its default mode
  is training, and --vis renders a depth map (tests/test_torch_fusion.py
  holds fusion and the render against the JAX package);
* warp_impl="epipolar" builds, is never what "auto" means, reports which
  pairs took the sweep, and takes no sweep in training mode;
* the seeded initialisation depends on the seed alone.
"""

import ast
import os
import subprocess
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import dmvsnet_tpu_torch
from dmvsnet_tpu_torch import cli, resolve_device
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.engine.evaluate import build_model, run_test
from dmvsnet_tpu_torch.engine.train import Trainer
from dmvsnet_tpu_torch.engine.train import build_model as build_train_model
from dmvsnet_tpu_torch.models import mvsnet
from dmvsnet_tpu_torch.parallel import Mesh
from dmvsnet_tpu_torch.utils import synthetic

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dmvsnet_tpu"}
PORT_ROOT = Path(dmvsnet_tpu_torch.__file__).parent
REPO = PORT_ROOT.parent


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
    # the training slice's and the recipes slice's modules are under the walk
    assert {"losses/mvs_loss.py", "losses/metrics.py", "losses/alt_losses.py",
            "engine/state.py", "engine/steps.py", "engine/checkpoint.py", "engine/train.py",
            "engine/imagery.py", "data/dtu.py", "data/loader.py", "data/blendedmvs.py",
            "fusion/__init__.py", "fusion/ply.py", "fusion/geometry_np.py", "fusion/pcd.py",
            "fusion/dypcd.py", "fusion/dtu_eval.py", "fusion/tank_config.py",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py"} <= names
    # and so are the smoke run and the port's scripts
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert [f.name for f in scripts] == ["torch_dtu_eval.py"]
    files += [REPO / "chip_smoke.py", *scripts]
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad
    # the port runs where matplotlib is not installed: --vis uses engine/colormap.py
    assert not [f for f in files for root, _ in _imported_roots(f) if root == "matplotlib"]
    # the walk itself sees the allowed package name as distinct
    assert "dmvsnet_tpu_torch" not in FORBIDDEN


@pytest.mark.parametrize("recipe", ["dtu_train", "dtu_test", "tank_test",
                                    "blendedmvs_finetune"])
def test_torch_launchers_run_the_port_cli_at_their_preset(recipe):
    """scripts/torch_<recipe>.sh parses (bash -n) and runs the port's CLI
    with --preset <recipe>; the JAX launcher beside it runs the JAX CLI."""
    path = REPO / "scripts" / f"torch_{recipe}.sh"
    subprocess.run(["bash", "-n", str(path)], check=True, timeout=60)
    text = path.read_text()
    assert "python -m dmvsnet_tpu_torch.cli" in text and f"--preset {recipe}" in text
    assert "dmvsnet_tpu.cli" not in text and os.access(path, os.X_OK)
    assert "python -m dmvsnet_tpu.cli" in (REPO / "scripts" / f"{recipe}.sh").read_text()


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
    with pytest.raises(ValueError, match="warp_impl"):
        build_model(_cfg(scene, warp_impl="pallas"), cpu)
    # ported in the eighth slice: adaptive aggregation and the bf16 policies
    # build (the cost passes on the CPU take the plain version)
    adaptive = build_model(_cfg(scene, agg_mode="adaptive"), cpu)
    assert adaptive.agg_mode == "adaptive" and adaptive.warp_impl == "torch"
    bf16 = build_model(_cfg(scene, costreg_dtype="bfloat16"), cpu)
    assert bf16.costreg_dtype == torch.bfloat16 and bf16.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="costreg_dtype"):
        build_model(_cfg(scene, costreg_dtype="float16"), cpu)
    with pytest.raises(NotImplementedError, match="fea_mode"):
        build_model(_cfg(scene, fea_mode="unet"), cpu)
    with pytest.raises(ValueError, match="CUDA device"):
        build_model(_cfg(scene, warp_impl="cuda"), cpu)
    with pytest.raises(NotImplementedError, match="gipuma"):
        run_test(_cfg(scene).replace(filter_method="gipuma"), device="cpu")
    assert not os.path.exists(scene / "out")
    assert build_model(_cfg(scene), cpu).warp_impl == "torch"
    # training: remat, bf16 and adaptive build, and so does sp (ported in
    # the ninth slice): a model on an sp mesh splits the rows of its cost
    # U-Nets and of nothing else (tests/test_torch_spatial.py runs it and
    # the Trainer on 2 ranks); one process cannot hold two sp ranks
    train_cfg = preset("dtu_train", datapath=str(scene / "data"))
    assert build_train_model(train_cfg.replace(remat=True), cpu).remat
    assert build_train_model(train_cfg.replace(compute_dtype="bfloat16"),
                             cpu).compute_dtype == torch.bfloat16
    assert build_train_model(train_cfg.replace(agg_mode="adaptive"),
                             cpu).agg_mode == "adaptive"
    sp_mesh = Mesh({"dp": 1, "vp": 1, "sp": 2}, {"dp": 0, "vp": 0, "sp": 0}, {}, cpu)
    sp_model = build_train_model(train_cfg.replace(mesh_spatial=2), cpu, sp_mesh)
    split = {n for n, m in sp_model.named_modules() if getattr(m, "spatial", None) is sp_mesh}
    assert split and all(n.startswith("cost_regularization") for n in split)
    with pytest.raises(ValueError, match="each of the 1 ranks"):
        Trainer(train_cfg.replace(mesh_spatial=2), device="cpu")
    model = build_train_model(train_cfg, cpu)
    assert model.training and model.warp_impl == "torch"
    assert not build_model(_cfg(scene), cpu).training


def test_epipolar_builds_and_is_never_what_auto_means(scene):
    """warp_impl="epipolar" builds on the CPU with the routing defaults, auto
    still resolves to the exact path, and a model in training mode sends
    every pass to the exact path (no flag set, the gradient flows)."""
    cpu = torch.device("cpu")
    assert build_model(_cfg(scene), cpu).warp_impl == "torch"
    model = build_model(_cfg(scene, warp_impl="epipolar"), cpu)
    assert model.warp_impl == "epipolar" and not model.training
    assert model.epipolar_main_stages == mvsnet.EPIPOLAR_MAIN_STAGES
    assert model.epipolar_refine_stages == mvsnet.EPIPOLAR_REFINE_STAGES
    train_cfg = preset("dtu_train", datapath=str(scene / "data"), warp_impl="epipolar",
                       ndepths=(8, 8, 8))
    trained = build_train_model(train_cfg, cpu)
    assert trained.training and trained.warp_impl == "epipolar"
    trained.epipolar_main_stages = trained.epipolar_refine_stages = (0, 1, 2)
    cams = np.stack([synthetic.camera_stack(115.0, 115.0, 48.0, 32.0, tx=-80.0 * i)
                     for i in range(3)])
    proj = {k: torch.from_numpy(p[None].copy())
            for k, p in synthetic.stage_projections(cams).items()}
    imgs = torch.rand((1, 3, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    out = trained(imgs, proj, torch.linspace(425.0, 935.0, 48)[None])
    for s in range(3):
        st = out[f"stage{s + 1}"]
        assert not st["sweep_engaged"].any() and not st["sweep_engaged_refine"].any()
    assert out["depth"].requires_grad


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
    png = cli.main(["--vis", "--depth_path", str(scene / "out/scan1/depth_est/00000001.pfm"),
                    "--depth_img_save_dir", str(scene / "vis")])["png"]
    assert Image.open(png).size == (96, 64)
    with pytest.raises(SystemExit):
        cli.main(["--vis"])  # nothing to render
    # without a mode flag the CLI trains: on the eval scene it gets as far as
    # looking for the DTU training tree
    with pytest.raises(FileNotFoundError, match="pair.txt"):
        cli.main(["--preset", "dtu_train", "--device", "cpu", "--datapath",
                  str(scene / "data"), "--trainlist", "scan1", "--testlist", "scan1"])


def test_console_script_returns_none_after_a_run(tmp_path, monkeypatch, capsys):
    """The console script passes what its function returns to sys.exit, so
    that function must return None after a successful run (a dict would
    print itself and exit 1); main keeps returning the summary."""
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["dmvsnet-torch"] == "dmvsnet_tpu_torch.cli:console_main"
    pfm = str(tmp_path / "depth.pfm")
    io.save_pfm(pfm, np.linspace(400, 900, 64 * 96, dtype=np.float32).reshape(64, 96))
    argv = ["--vis", "--depth_path", pfm, "--depth_img_save_dir", str(tmp_path / "vis")]
    monkeypatch.setattr("sys.argv", ["dmvsnet-torch", *argv])
    assert cli.console_main() is None
    assert Image.open(tmp_path / "vis" / "depth.png").size == (96, 64)
    assert "saved" in capsys.readouterr().out
    assert cli.main(argv)["mode"] == "vis"


def test_cli_epipolar_test_path_on_cpu_reports_the_flags(scene):
    """--warp_impl epipolar through the CLI: depth maps as on the exact path,
    and per dispatch the (B, V-1) flags of all six passes; the passes the
    defaults do not route report no view."""
    summary = cli.main([
        "--test", "--preset", "dtu_test", "--device", "cpu", "--warp_impl", "epipolar",
        "--datapath", str(scene / "data"), "--testlist", "scan1",
        "--outdir", str(scene / "out"), "--ndepths", "8", "8", "8",
        "--max_h", "64", "--max_w", "96", "--num_view", "3", "--filter_method", "none",
    ])
    assert summary["maps"] == 3
    depth, _ = io.read_pfm(str(scene / "out/scan1/depth_est/00000001.pfm"))
    assert depth.shape == (64, 96) and np.isfinite(depth).all()
    assert len(summary["sweep_engaged"]) == 2  # eval_batch 2: two dispatches
    for dispatch in summary["sweep_engaged"]:
        assert set(dispatch) == {f"stage{s}{r}" for s in (1, 2, 3) for r in ("", "_refine")}
        for s in range(3):
            for suffix, routed in (("", mvsnet.EPIPOLAR_MAIN_STAGES),
                                   ("_refine", mvsnet.EPIPOLAR_REFINE_STAGES)):
                flags = dispatch[f"stage{s + 1}{suffix}"]
                assert len(flags) == 2 and all(len(row) == 2 for row in flags)
                if s not in routed:
                    assert not any(any(row) for row in flags)
        assert all(all(row) for row in dispatch["stage1"])
    exact = cli.main([
        "--test", "--preset", "dtu_test", "--device", "cpu",
        "--datapath", str(scene / "data"), "--testlist", "scan1",
        "--outdir", str(scene / "out_exact"), "--ndepths", "8", "8", "8",
        "--max_h", "64", "--max_w", "96", "--num_view", "3", "--filter_method", "none",
    ])
    assert "sweep_engaged" not in exact


def test_seeded_init_depends_on_the_seed_alone(scene):
    cpu = torch.device("cpu")
    a = build_model(_cfg(scene, seed=3), cpu).state_dict()
    b = build_model(_cfg(scene, seed=3), cpu).state_dict()
    c = build_model(_cfg(scene, seed=4), cpu).state_dict()
    w = "feature.conv0.0.conv.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["cost_regularization.1.cosR_huge.conv3.bn.running_var"] == 1.0)
