"""The spatial mesh axis of the port (sp) on the CPU: ranks are processes
joined by gloo under torchrun, with a time limit each
(tests/test_torch_parallel.py's ``run_ranks``).

Run by path, this file is the ranks' worker (``python
tests/test_torch_spatial.py TASK DIR``, under torchrun): it imports neither
JAX nor the JAX package.  As a test file it holds:

* (a) the mesh layout (``parallel.mesh.mesh_layout``) against
  ``np.arange(world).reshape(n_data, n_view, n_spatial)``: coordinates and
  every group, for (dp, vp, sp) = (2, 1, 2), (1, 2, 2) and (2, 2, 2);
* (b) on 2 ranks, uneven bands of 24 + 16 rows: the halo-exchanged
  ``ConvBlock`` (3-D stride 1 and 2, 2-D stride 1 and 2), ``DeconvBlock``
  (2-D and 3-D) and whole ``CostRegNet`` / ``CostRegNetRefine`` (and a
  ``CostRegNet`` whose level 0 runs folded, ``fold_level0=True``) in train
  mode against the unsplit module on the whole input: output, input
  gradient, weight gradient (summed over the ranks) and the new running
  statistics, at 1e-5 relative;
* (c) the sp = 2 eval forward of ``MVSNet`` at 64x96, 3 views, 8/8/8,
  batch 2, against the JAX package's ``MVSNet.apply`` on the same weights
  (one jitted JAX forward) with tests/test_torch_slice.py's whole-model
  tolerances (depth 0.01 mm, confidence 1e-4), and against the
  one-process port at 1e-5 relative;
* the Trainer on 2 sp ranks: both load the same samples (the loader is
  sharded by the dp coordinate, not by rank), the whole batch each, and
  log the same scalars;
* (d) in this process, on a mesh object without process groups: a band
  that would be empty raises, and a stage whose height does not divide
  over sp runs unsplit and is counted.

tests/test_torch_train_step.py holds the sp and dp x sp train steps (and
an sp remat step) against the JAX step.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_parallel import _worker, collect, run_ranks

from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.engine.train import Trainer
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock, init_weights, spatial_split
from dmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetRefine
from dmvsnet_tpu_torch.parallel import Mesh, make_mesh, spatial
from dmvsnet_tpu_torch.parallel.mesh import mesh_layout
from dmvsnet_tpu_torch.utils import synthetic

WORKER = Path(__file__).resolve()
REL_TOL = 1e-5
# tests/test_torch_slice.py's whole-model tolerances: the heads' 1e-3 mm of
# tests/test_torch_models.py is finer than the one-process port's own
# distance from JAX on this batch (1.16e-3 mm)
DEPTH_TOL_MM, CONF_TOL = 0.01, 1e-4
H = 40  # two bands of 24 + 16 rows
# each module case: factory, input shape (H at axis -2), output rows per input row
BLOCKS = {
    "conv3d_s1": (lambda: ConvBlock(3, 4, dims=3), (2, 3, 4, H, 12), 1.0),
    "conv3d_s2": (lambda: ConvBlock(3, 4, stride=2, dims=3), (2, 3, 4, H, 12), 0.5),
    "conv2d_s1": (lambda: ConvBlock(3, 4, dims=2), (2, 3, H, 12), 1.0),
    "conv2d_s2": (lambda: ConvBlock(3, 4, stride=2, dims=2), (2, 3, H, 12), 0.5),
    "deconv2d": (lambda: DeconvBlock(4, 3, dims=2), (2, 4, H, 12), 2.0),
    "deconv3d": (lambda: DeconvBlock(4, 3, dims=3), (2, 4, 4, H, 12), 2.0),
    "costregnet": (lambda: CostRegNet(4), (2, 2, 8, H, 16), 1.0),
    "costregnet_refine": (lambda: CostRegNetRefine(4), (2, 2, 4, H, 16), 1.0),
    # level 0 folded (models/folded.py): folded bands of 12 + 8 rows
    "costregnet_folded": (lambda: CostRegNet(4, fold_level0=True), (2, 2, 8, H, 16), 1.0),
}
NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)


def _randomized(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Seeded weights and random batch-norm parameters and statistics."""
    init_weights(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module


def _scaled(bands, f: float):
    return [(int(a * f), int(b * f)) for a, b in bands]


# ---------------------------------------------------------------- worker

def _blocks_task(inputs: dict, rank: int, world: int) -> dict:
    """Every module of BLOCKS on this rank's band, in train mode."""
    mesh = make_mesh(n_data=1, n_spatial=world)
    bands = spatial.row_bands(H, world)
    out = {}
    for name, (factory, shape, f) in BLOCKS.items():
        case = inputs["blocks"][name]
        module = factory()
        module.load_state_dict(case["state"])
        spatial_split(module.train(), mesh)
        h_axis = len(shape) - 2
        x = spatial.take_rows(case["x"], h_axis, bands[rank]).clone().requires_grad_()
        with spatial.split_rows():
            y = module(x)
        out_bands = _scaled(bands, f)
        (y * spatial.take_rows(case["cot"], h_axis, out_bands[rank])).sum().backward()
        with torch.no_grad():
            out[name] = dict(
                y=spatial.gather_rows(y, mesh, h_axis, out_bands),
                x_grad=spatial.gather_rows(x.grad, mesh, h_axis, bands),
                grads={n: mesh.all_reduce(p.grad, "sp") for n, p in module.named_parameters()},
                state={k: v.clone() for k, v in module.state_dict().items()})
    return out


def _forward_task(inputs: dict, rank: int, world: int) -> dict:
    """The MVSNet eval forward with the rows split over ``world`` sp ranks."""
    mesh = make_mesh(n_data=1, n_spatial=world)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="cuda", mesh=mesh)
    model.load_state_dict(inputs["model"])
    spatial.stats["unsplit_passes"] = 0
    with torch.inference_mode():
        o = model.eval()(*inputs["args"])
    return dict(depth=o["depth"], conf=o["photometric_confidence"],
                stages={s: {k: o[s][k] for k in ("depth", "photometric_confidence",
                                                 "depth_sub_plus", "prob_volume")}
                        for s in ("stage1", "stage2", "stage3")},
                unsplit=spatial.stats["unsplit_passes"], coords=mesh.coords)


def _trainer_task(inputs: dict, rank: int, world: int) -> dict:
    """The Trainer with mesh_spatial = world: what each rank loads, one epoch."""
    trainer = Trainer(Config(**inputs["cfg"]), device="cpu")
    trainer.train_loader.set_epoch(0)
    first = next(iter(trainer.train_loader))
    return dict(mesh=trainer.mesh.shape, shard=trainer.train_loader._host_indices().tolist(),
                first_imgs=torch.from_numpy(first["imgs"]), history=trainer.train(),
                ddp=type(trainer.net).__name__)


def _sp_task(inputs: dict, rank: int, world: int) -> dict:
    return dict(blocks=_blocks_task(inputs, rank, world),
                forward=_forward_task(inputs, rank, world),
                trainer=_trainer_task(inputs, rank, world))


TASKS = {"sp": _sp_task}


# ----------------------------------------------------------------- tests


def _inputs(root: Path) -> dict:
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    blocks = {}
    for name, (factory, shape, f) in BLOCKS.items():
        module = _randomized(factory(), gen)
        out_shape = list(factory()(torch.zeros(shape)).shape)
        blocks[name] = dict(
            state=module.state_dict(),
            x=torch.from_numpy(rng.normal(0.5, 1.0, shape).astype(np.float32)),
            cot=torch.from_numpy(rng.normal(0, 1, out_shape).astype(np.float32)))
    model = _randomized(MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS,
                               inverse_depth=True, warp_impl="torch"), gen)
    batch = synthetic.make_batch(batch=2, n_views=3, height=64, width=96, n_depths=32)
    batch["imgs"][1] = batch["imgs"][1, :, ::-1].copy()  # two different batch elements
    args = (torch.from_numpy(batch["imgs"]),
            {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
            torch.from_numpy(batch["depth_values"]))
    synthetic.write_dtu_training_tree(str(root / "dtu"), scans=("scan1",), n_views=3,
                                      height=64, width=160)
    cfg = dict(datapath=str(root / "dtu"), log_dir=str(root / "logs"), trainlist="scan1",
               testlist="scan1", dataset_name="dtu_yao", nviews=3, batch_size=2, epochs=1,
               ndepths=(8, 8, 8), interval_ratio=(4, 2, 1), numdepth=16, eval_freq=10,
               summary_freq=1, img_size=(64, 160), max_train_samples=4, max_val_samples=2,
               mesh_spatial=2)
    return dict(blocks=blocks, model=model.state_dict(), batch=batch, args=args, cfg=cfg)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    inputs = _inputs(root)
    torch.save(inputs, root / "inputs.pt")
    return inputs, collect(run_ranks("sp", 2, root, worker=WORKER))


@pytest.mark.parametrize("n_data,n_view,n_spatial", [(2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_mesh_layout_is_the_jax_device_grid(n_data, n_view, n_spatial):
    world = n_data * n_view * n_spatial
    grid = np.arange(world).reshape(n_data, n_view, n_spatial)
    layout = mesh_layout(world, n_data, n_view, n_spatial)
    for r, c in enumerate(layout["coords"]):
        assert grid[c["dp"], c["vp"], c["sp"]] == r
    groups = layout["groups"]
    want = {"dp": [list(grid[:, v, s]) for v in range(n_view) for s in range(n_spatial)],
            "vp": [list(grid[d, :, s]) for d in range(n_data) for s in range(n_spatial)],
            "sp": [list(grid[d, v, :]) for d in range(n_data) for v in range(n_view)],
            ("dp", "sp"): [sorted(grid[:, v, :].ravel()) for v in range(n_view)]}
    assert set(groups) == set(want)
    for axis, lists in want.items():
        assert sorted(map(sorted, groups[axis])) == sorted(map(sorted, lists)), axis
        # every rank in exactly one group of each axis
        assert sorted(r for g in groups[axis] for r in g) == list(range(world)), axis
    with pytest.raises(ValueError, match=f"each of the {world + 1} ranks"):
        mesh_layout(world + 1, n_data, n_view, n_spatial)


def test_row_bands():
    assert spatial.row_bands(216, 2) == [(0, 112), (112, 216)]   # dtu_test, stage 1
    assert spatial.row_bands(432, 2) == [(0, 216), (216, 432)]
    assert spatial.row_bands(40, 2) == [(0, 24), (24, 40)]
    assert spatial.row_bands(24, 3) == [(0, 8), (8, 16), (16, 24)]


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    err = float((got - want).abs().max())
    assert err <= REL_TOL * max(1.0, float(want.abs().max())), (what, err)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_banded_module_matches_unsplit(ranked, name):
    inputs, ranks = ranked
    case = inputs["blocks"][name]
    factory, shape, _ = BLOCKS[name]
    module = factory()
    module.load_state_dict(case["state"])
    x = case["x"].clone().requires_grad_()
    y = module.train()(x)
    (y * case["cot"]).sum().backward()
    for r in ranks:
        got = r["blocks"][name]
        _close(got["y"], y.detach(), "output")
        _close(got["x_grad"], x.grad, "input gradient")
        for n, p in module.named_parameters():
            _close(got["grads"][n], p.grad, n)
        for k, v in module.state_dict().items():
            if "running" in k:
                _close(got["state"][k], v, k)
                assert not torch.equal(v, case["state"][k]), k
            else:
                assert torch.equal(got["state"][k], v), k


@pytest.fixture(scope="module")
def jax_forward(ranked):
    import jax
    import jax.numpy as jnp

    from dmvsnet_tpu.models import MVSNet as JMVSNet

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(WORKER)), "tools"))
    from convert_torch_ckpt import convert_state_dict

    inputs, _ = ranked
    params, stats = convert_state_dict({k: v.numpy() for k, v in inputs["model"].items()})
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True)
    batch = inputs["batch"]
    out = jax.jit(jm.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
        jnp.asarray(batch["depth_values"]))
    return {k: np.asarray(out[k]) for k in ("depth", "photometric_confidence")}


def test_sp_eval_forward_matches_jax(ranked, jax_forward):
    inputs, ranks = ranked
    assert [r["forward"]["coords"]["sp"] for r in ranks] == [0, 1]
    for r in ranks:
        f = r["forward"]
        assert f["unsplit"] == 0 and f["depth"].shape == (2, 64, 96)
        depth = float(np.abs(f["depth"].numpy() - jax_forward["depth"]).max())
        conf = float(np.abs(f["conf"].numpy() - jax_forward["photometric_confidence"]).max())
        print(f"sp=2 eval forward vs JAX: depth {depth:.2e} mm, confidence {conf:.2e}")
        assert depth <= DEPTH_TOL_MM and conf <= CONF_TOL


def test_sp_eval_forward_matches_one_process(ranked):
    inputs, ranks = ranked
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="cuda")
    model.load_state_dict(inputs["model"])
    with torch.inference_mode():
        o = model.eval()(*inputs["args"])
    for r in ranks:
        for s, got in r["forward"]["stages"].items():
            for k, v in got.items():
                _close(v, o[s][k], (s, k))
    # both ranks hold the same whole maps
    assert torch.equal(ranks[0]["forward"]["depth"], ranks[1]["forward"]["depth"])


def test_trainer_on_two_sp_ranks_loads_the_same_samples(ranked):
    _, (r0, r1) = ranked
    t0, t1 = r0["trainer"], r1["trainer"]
    assert t0["mesh"] == t1["mesh"] == {"dp": 1, "vp": 1, "sp": 2}
    # the whole batch on both ranks: the loader is sharded over dp, not ranks
    assert t0["shard"] == t1["shard"] and sorted(t0["shard"]) == list(range(4))
    assert t0["first_imgs"].shape[0] == 2 and torch.equal(t0["first_imgs"], t1["first_imgs"])
    h0, h1 = t0["history"][0], t1["history"][0]
    assert h0["train_avg"] == h1["train_avg"] and h0["val_avg"] == h1["val_avg"]
    assert all(np.isfinite(v) for v in h0["train_avg"].values())
    assert t0["ddp"] == "DistributedDataParallel"


def _fake_mesh(sp: int) -> Mesh:
    """An sp mesh without process groups: enough for what raises or stays
    unsplit before any collective."""
    return Mesh({"dp": 1, "vp": 1, "sp": sp}, {"dp": 0, "vp": 0, "sp": 0}, {},
                torch.device("cpu"))


def test_empty_band_raises():
    with pytest.raises(ValueError, match="stage height 8 leaves a band empty over sp=2"):
        spatial.row_bands(8, 2)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, warp_impl="torch",
                   mesh=_fake_mesh(2)).eval()
    batch = synthetic.make_batch(batch=1, n_views=3, height=32, width=64, n_depths=16)
    with pytest.raises(ValueError, match="stage height 8 leaves a band empty over sp=2"):
        with torch.inference_mode():
            model(torch.from_numpy(batch["imgs"]),
                  {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                  torch.from_numpy(batch["depth_values"]))


def test_stage_height_not_divisible_by_sp_runs_unsplit():
    gen = torch.Generator().manual_seed(1)
    plain = _randomized(MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS,
                               warp_impl="torch"), gen).eval()
    split = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, warp_impl="torch",
                   mesh=_fake_mesh(3)).eval()
    split.load_state_dict(plain.state_dict())
    batch = synthetic.make_batch(batch=1, n_views=3, height=64, width=96, n_depths=16)
    args = (torch.from_numpy(batch["imgs"]),
            {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
            torch.from_numpy(batch["depth_values"]))
    spatial.stats["unsplit_passes"] = 0
    with torch.inference_mode():
        want, got = plain(*args), split(*args)
    # 16, 32 and 64 rows do not divide over 3 ranks: all six passes unsplit
    assert spatial.stats["unsplit_passes"] == 6
    assert torch.equal(got["depth"], want["depth"])
    assert torch.equal(got["photometric_confidence"], want["photometric_confidence"])


if __name__ == "__main__":
    _worker(*sys.argv[1:3], tasks=TASKS)
