"""Data parallelism of the port on the CPU: ranks are processes joined by
gloo, launched by torchrun (``run_ranks``), each with a time limit.

Run by path, this file is the ranks' worker (``python
tests/test_torch_parallel.py TASK DIR``, under torchrun): it imports
neither JAX nor the JAX package, reads its inputs from DIR/inputs.pt and
writes DIR/TASK_rank{r}.pt.  As a test file it holds what the ranks return
against the JAX package:

* the synced batch norm on 2 ranks against flax ``BatchNorm`` over the
  joined batch, 2-D and 3-D: output, input gradient, scale / bias gradient
  (summed over ranks) and the new running mean / variance;
* on the same ranks, ``parallel.mesh.all_reduces``: the batch norms' and
  the view sum's all_reduces counted by label, calls and bytes;
* ``aggregate_cost_volume_view_sharded`` on 2 and 4 ranks against the JAX
  function on the virtual CPU mesh of tests/conftest.py (32x32, V = 5, 8
  planes; 1e-5, as tests/test_sharding.py holds the JAX one against the
  serial sum), and the feature gradient through the all_reduce against the
  one-rank port's;
* the Trainer on 2 ranks: disjoint loader shards, equal scalars on both
  ranks, one checkpoint in the reference naming written by rank 0 alone,
  resume on both ranks, and the note (then the refusal) for mesh_data=3;
* in this process: ``init_multihost`` without an environment, with the JAX
  package's variables, and with an incomplete one; the refusals of
  WORLD_SIZE > 1 without a process group, of a mesh that does not hold
  the ranks, and of an empty sp band.

tests/test_torch_train_step.py runs the whole train step through this
worker on 2 dp, 2 vp, 2 sp and 2 dp x 2 sp ranks; tests/test_torch_spatial.py
runs its own tasks through ``run_ranks`` and ``_worker``.
"""

from __future__ import annotations

import contextlib
import io as stdio
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.engine.train import Trainer, data_parallel
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import BatchNorm2d, BatchNorm3d, sync_batch_norm
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.parallel import Mesh, init_multihost, make_mesh, spatial
from dmvsnet_tpu_torch.parallel import mesh as mesh_lib
from dmvsnet_tpu_torch.utils import synthetic

WORKER = Path(__file__).resolve()
REPO = WORKER.parent.parent
RANK_TIMEOUT_S = 240


def run_ranks(task: str, world: int, out_dir: Path, timeout_s: float = RANK_TIMEOUT_S,
              worker: Path = WORKER):
    """Starts ``world`` gloo ranks of ``worker`` (a test file that runs
    ``_worker`` with its own tasks; this one by default) under torchrun on
    ``task``; returns a Popen-like handle for ``collect``."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), str(worker), task, str(out_dir)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    return proc, task, world, out_dir, timeout_s


def collect(handle) -> list[dict]:
    """Waits for the ranks of ``run_ranks`` (killing all of them at the time
    limit) and returns what each rank wrote, in rank order."""
    proc, task, world, out_dir, timeout_s = handle
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, f"{task} on {world} ranks failed:\n{out[-6000:]}"
    return [torch.load(out_dir / f"{task}_rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- worker

def _bn_task(inputs: dict, rank: int, world: int) -> dict:
    """Both batch norms on this rank's share of the batch, synced over the
    world: output, gradients, new running statistics; then the eval-mode
    output against an unsynced copy; the all_reduces issued."""
    mesh_lib.reset_all_reduces()
    out = {}
    for dims, cls in ((2, BatchNorm2d), (3, BatchNorm3d)):
        case = inputs[f"bn{dims}d"]
        n = case["x"].shape[0] // world
        bn = cls(case["x"].shape[1], eps=1e-5, momentum=0.1)
        bn.load_state_dict(case["state"], strict=False)
        plain = cls(case["x"].shape[1], eps=1e-5, momentum=0.1)
        plain.load_state_dict(bn.state_dict())
        sync_batch_norm(bn, dist.group.WORLD)
        x = case["x"][rank * n:(rank + 1) * n].clone().requires_grad_()
        y = bn.train()(x)
        (y * case["cot"][rank * n:(rank + 1) * n]).sum().backward()
        with torch.no_grad():
            plain.load_state_dict(bn.state_dict())
            eval_equal = torch.equal(bn.eval()(x), plain.eval()(x))
        out[f"bn{dims}d"] = dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                                 bias_grad=bn.bias.grad, mean=bn.running_mean.clone(),
                                 var=bn.running_var.clone(), eval_equal=eval_equal,
                                 tracked=int(bn.num_batches_tracked))
    out["bn_all_reduces"] = mesh_lib.all_reduces()
    return out


def _view_task(inputs: dict, rank: int, world: int) -> dict:
    """The view-sharded cost pass over ``world`` vp ranks and the feature
    gradient through it; the all_reduces issued."""
    mesh = make_mesh(n_data=1, n_view=world)
    feats = inputs["feats"].clone().requires_grad_()
    mesh_lib.reset_all_reduces()
    cost = wc.aggregate_cost_volume_view_sharded(feats, inputs["proj2"], inputs["dv"], mesh)
    (cost * inputs["cot"]).sum().backward()
    return dict(cost=cost.detach(), grad=feats.grad, coords=mesh.coords,
                view_all_reduces=mesh_lib.all_reduces())


def _step_task(inputs: dict, rank: int, world: int) -> dict:
    """One train step of the port on a dp, vp, sp or dp x sp mesh
    (``STEP_MESHES``): the model in DDP, the step of engine/steps.py,
    learning rate 0 (the gradients stay in .grad).  With ``inputs["remat"]``
    the step runs under deterministic algorithms, and the same step with
    remat follows under "remat" (its recomputed synced batch norms, and on
    sp its halo exchanges, all_reduce again inside the backward)."""
    if not inputs.get("remat"):
        return _one_step(inputs, rank, world, remat=False)
    torch.use_deterministic_algorithms(True)
    return dict(_one_step(inputs, rank, world, remat=False),
                remat=_one_step(inputs, rank, world, remat=True))


# the mesh of each mode of the step task on ``world`` ranks: dp, one batch
# element per rank; vp, one source view per rank; sp, the rows of every
# cost U-Net split over the ranks; dpsp, 2 dp x world/2 sp
STEP_MESHES = {"dp": lambda world: dict(n_data=world),
               "vp": lambda world: dict(n_data=1, n_view=world),
               "sp": lambda world: dict(n_data=1, n_spatial=world),
               "dpsp": lambda world: dict(n_data=2, n_spatial=world // 2)}


def _one_step(inputs: dict, rank: int, world: int, remat: bool) -> dict:
    mesh = make_mesh(**STEP_MESHES[inputs["mode"]](world))
    model = MVSNet(ndepths=inputs["ndepths"], depth_interval_ratio=inputs["ratios"],
                   inverse_depth=True, warp_impl="cuda", mesh=mesh, remat=remat)
    model.load_state_dict(inputs["sd0"])
    batch = inputs["batch"]
    if mesh.size("dp") > 1:  # dp rank d holds element d of the global batch
        d = mesh.coords["dp"]

        def take(v):
            return {k: take(x) for k, x in v.items()} if isinstance(v, dict) else v[d:d + 1]
        batch = take(batch)
    opt, sched = make_optimizer(model.parameters(), lambda n: 0.0)
    step = make_train_step(inputs["dlossw"], "regression", mesh)
    scalars, (depth, _) = step(data_parallel(model), opt, sched, batch)
    return dict(scalars={k: float(v) for k, v in scalars.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                state=model.state_dict(), depth=depth,
                mask_count=float(batch["mask"]["stage3"].sum()))


def _trainer_task(inputs: dict, rank: int, world: int) -> dict:
    """The Trainer on every rank: shards, one epoch, resume, and the note
    for a dp axis that does not divide the batch."""
    cfg = Config(**inputs["cfg"])
    trainer = Trainer(cfg, device="cpu")
    trainer.train_loader.set_epoch(0)
    shard = trainer.train_loader._host_indices().tolist()
    first = next(iter(trainer.train_loader))
    history = trainer.train()
    resumed = Trainer(cfg.replace(resume=history[0]["checkpoint"]), device="cpu")
    opt_steps = {int(s["step"]) for s in resumed.optimizer.state_dict()["state"].values()}
    same_weights = all(torch.equal(v, resumed.model.state_dict()[k])
                       for k, v in trainer.model.state_dict().items())
    printed = stdio.StringIO()
    refusal = None
    with contextlib.redirect_stdout(printed):
        try:
            Trainer(cfg.replace(mesh_data=3), device="cpu")
        except ValueError as e:
            refusal = str(e)
    return dict(shard=shard, per_rank_batch=int(first["imgs"].shape[0]), history=history,
                steps=trainer.step, resumed_epoch=resumed.start_epoch,
                resumed_step=resumed.step, opt_steps=sorted(opt_steps),
                same_weights=same_weights, mesh_data_3_stdout=printed.getvalue(),
                mesh_data_3_refusal=refusal, ddp=type(trainer.net).__name__,
                writes_tensorboard=trainer.writer is not None)


TASKS = {"bn_view": lambda i, r, w: {**_bn_task(i, r, w), **_view_task(i, r, w)},
         "view": _view_task, "step": _step_task, "trainer": _trainer_task}


def _worker(task: str, out_dir: str, tasks: dict | None = None) -> None:
    torch.set_num_threads(1)
    info = init_multihost("cpu")
    rank, world = info["process_index"], info["process_count"]
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    result = (TASKS if tasks is None else tasks)[task](inputs, rank, world)
    result["init"] = info
    result["backend"] = dist.get_backend()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "dmvsnet_tpu"))
    if leaked:
        raise RuntimeError(f"the worker imported {leaked}")
    torch.save(result, os.path.join(out_dir, f"{task}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------- tests


def _bn_inputs(rng) -> dict:
    out = {}
    for dims, shape in ((2, (4, 3, 6, 5)), (3, (4, 3, 4, 6, 5))):
        c = shape[1]
        state = dict(weight=torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                     bias=torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
                     running_mean=torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)),
                     running_var=torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
        out[f"bn{dims}d"] = dict(
            x=torch.from_numpy(rng.normal(1.5, 2.0, shape).astype(np.float32)),
            cot=torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)), state=state)
    return out


def _view_inputs(rng) -> dict:
    batch = synthetic.make_batch(batch=2, n_views=5, height=32, width=32, n_depths=8)
    return dict(feats=torch.from_numpy(rng.normal(size=(2, 5, 32, 32, 8)).astype(np.float32)),
                proj2=torch.from_numpy(batch["proj_matrices"]["stage3"]),
                dv=torch.from_numpy(batch["depth_values"]),
                cot=torch.from_numpy(rng.normal(size=(2, 8, 32, 32, 2)).astype(np.float32)))


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The batch-norm and 2-rank view tasks in one 2-rank run, the view task
    on 4 ranks beside it."""
    rng = np.random.default_rng(0)
    inputs = {**_bn_inputs(rng), **_view_inputs(rng)}
    runs = {}
    for task, world in (("bn_view", 2), ("view", 4)):
        d = tmp_path_factory.mktemp(f"{task}{world}")
        torch.save(inputs, d / "inputs.pt")
        runs[world] = run_ranks(task, world, d)
    return inputs, {world: collect(h) for world, h in runs.items()}


@pytest.mark.parametrize("dims", [2, 3])
def test_synced_batch_norm_matches_flax_over_the_joined_batch(ranked, dims):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    inputs, results = ranked
    case, ranks = inputs[f"bn{dims}d"], [r[f"bn{dims}d"] for r in results[2]]
    perm = (0, *range(2, dims + 2), 1)  # channels last
    x, cot = (jnp.asarray(case[k].numpy().transpose(perm)) for k in ("x", "cot"))
    st = {k: jnp.asarray(v.numpy()) for k, v in case["state"].items()}
    variables = {"params": {"scale": st["weight"], "bias": st["bias"]},
                 "batch_stats": {"mean": st["running_mean"], "var": st["running_var"]}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def f(params, x):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

    y, new = f(variables["params"], x)
    _, vjp = jax.vjp(lambda p, x: f(p, x)[0], variables["params"], x)
    g_params, g_x = vjp(cot)
    inv = np.argsort(perm)

    def joined(key):
        return np.concatenate([r[key].numpy() for r in ranks])

    np.testing.assert_allclose(joined("y"), np.asarray(y).transpose(inv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(joined("x_grad"), np.asarray(g_x).transpose(inv),
                               rtol=1e-5, atol=1e-5)
    for key, want in (("weight_grad", g_params["scale"]), ("bias_grad", g_params["bias"])):
        got = sum(r[key].numpy() for r in ranks)  # each rank holds its share
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    for key, want in (("mean", new["batch_stats"]["mean"]), ("var", new["batch_stats"]["var"])):
        for r in ranks:
            np.testing.assert_allclose(r[key].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert all(r["eval_equal"] and r["tracked"] == 1 for r in ranks)
    assert [r["backend"] for r in results[2]] == ["gloo", "gloo"]


@pytest.mark.parametrize("world", [2, 4])
def test_view_sharded_cost_pass_matches_jax(ranked, world):
    import jax.numpy as jnp

    from dmvsnet_tpu.ops import warp as jwarp
    from dmvsnet_tpu.parallel.mesh import make_mesh as j_make_mesh

    inputs, results = ranked
    ranks = results[world]
    feats = inputs["feats"].numpy()
    want = np.asarray(jwarp.aggregate_cost_volume_view_sharded(
        [jnp.asarray(feats[:, i]) for i in range(5)], jnp.asarray(inputs["proj2"].numpy()),
        jnp.asarray(inputs["dv"].numpy()), j_make_mesh(n_data=1, n_view=world)))
    for r in ranks:
        np.testing.assert_allclose(r["cost"].numpy(), want, rtol=1e-5, atol=1e-5)
    assert [r["coords"]["vp"] for r in ranks] == list(range(world))

    # the gradient: DDP's mean over the ranks is the one-rank port's, and
    # each rank's source views outside its share get none
    f = inputs["feats"].clone().requires_grad_()
    (wc.aggregate_cost_volume(f, inputs["proj2"], inputs["dv"]) * inputs["cot"]).sum().backward()
    mean = sum(r["grad"] for r in ranks) / world
    assert float((mean - f.grad).abs().max()) <= 1e-5 * max(1.0, float(f.grad.abs().max()))
    k = 4 // world
    for i, r in enumerate(ranks):
        others = [v for v in range(1, 5) if not 1 + i * k <= v < 1 + (i + 1) * k]
        assert float(r["grad"][:, others].abs().max()) == 0.0


def test_all_reduces_are_counted_by_label(ranked):
    """Each psum is counted forward and backward under its label: two
    synced batch norms, each a (2 ranks, 3, 3 channels) fp32 table; one
    view sum of the (2, 8, 32, 32, 2) fp32 cost volume, on 2 and 4 ranks.
    The batch norms' eval-mode calls issue none."""
    inputs, results = ranked
    for r in results[2]:
        assert r["bn_all_reduces"] == {"batch_norm": {"calls": 4, "bytes": 4 * 2 * 3 * 3 * 4}}
    cost_bytes = inputs["cot"].numel() * 4
    for world in (2, 4):
        for r in results[world]:
            assert r["view_all_reduces"] == {"view_sum": {"calls": 2, "bytes": 2 * cost_bytes}}


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    synthetic.write_dtu_training_tree(str(root / "dtu"), scans=("scan1",), n_views=3,
                                      height=64, width=160)
    cfg = dict(datapath=str(root / "dtu"), log_dir=str(root / "logs"), trainlist="scan1",
               testlist="scan1", dataset_name="dtu_yao", nviews=3, batch_size=2, epochs=1,
               ndepths=(8, 8, 8), interval_ratio=(4, 2, 1), numdepth=16, eval_freq=10,
               summary_freq=1, img_size=(64, 160), max_train_samples=4, max_val_samples=2)
    torch.save({"cfg": cfg}, root / "inputs.pt")
    return root, collect(run_ranks("trainer", 2, root))


def test_trainer_on_two_ranks(trainer_ranks):
    root, ranks = trainer_ranks
    r0, r1 = ranks
    # disjoint shards of the epoch's permutation, one sample per rank and step
    assert not set(r0["shard"]) & set(r1["shard"])
    assert sorted(r0["shard"] + r1["shard"]) == list(range(4))
    assert r0["per_rank_batch"] == r1["per_rank_batch"] == 1
    # global scalars: exactly equal on both ranks, training and validation
    h0, h1 = r0["history"][0], r1["history"][0]
    assert h0["train_avg"] == h1["train_avg"] and h0["val_avg"] == h1["val_avg"]
    assert all(np.isfinite(v) for v in h0["train_avg"].values())
    assert r0["steps"] == r1["steps"] == 2 and r0["ddp"] == "DistributedDataParallel"
    # one checkpoint, rank 0's, in the reference naming; only rank 0 logs
    logs = sorted(os.listdir(root / "logs"))
    assert [f for f in logs if f.endswith(".ckpt")] == ["model_000000.ckpt"]
    assert (r0["writes_tensorboard"], r1["writes_tensorboard"]) == (True, False)
    assert not [f for f in logs if f.endswith(".tmp")]
    payload = torch.load(root / "logs" / "model_000000.ckpt", weights_only=True)
    assert set(payload["model"]) == set(MVSNet(ndepths=(8, 8, 8)).state_dict())
    assert payload["step"] == 2 and payload["epoch"] == 0
    # resume on both ranks
    for r in ranks:
        assert (r["resumed_epoch"], r["resumed_step"], r["opt_steps"]) == (1, 2, [2])
        assert r["same_weights"]
        # a dp axis that does not divide the batch: the note, then the refusal
        assert "dp mesh axis reduced to 1 (batch_size 2 must divide over it)" in r[
            "mesh_data_3_stdout"]
        assert r["mesh_data_3_refusal"] and "2 ranks" in r["mesh_data_3_refusal"]
    assert r0["init"] == dict(process_index=0, process_count=2, local_devices=1,
                              global_devices=2)


_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


def test_init_multihost_environments(clean_env):
    one = dict(process_index=0, process_count=1, local_devices=1, global_devices=1)
    assert init_multihost("cpu") == one and not dist.is_initialized()
    # the JAX package's variables, world size 1: a real gloo group
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    clean_env.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    clean_env.setenv("NUM_PROCESSES", "1")
    clean_env.setenv("PROCESS_ID", "0")
    try:
        assert init_multihost("cpu", timeout_s=60) == one
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert init_multihost("cpu") == one  # a second call keeps the group
    finally:
        dist.destroy_process_group()
    # more than one process named, but not where to meet: refused
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        clean_env.delenv(k)
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="incomplete"):
        init_multihost("cpu")


def test_more_than_one_rank_without_a_group_is_refused(clean_env, tmp_path):
    from dmvsnet_tpu_torch import cli

    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    cfg = Config(datapath=str(tmp_path), log_dir=str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        cli.main(["--test", "--device", "cpu", "--datapath", str(tmp_path)])
    assert not os.path.exists(tmp_path / "logs")


def test_mesh_axes_and_refusals(clean_env):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "vp": 1, "sp": 1} and mesh.groups == {}
    x = torch.ones(3, requires_grad=True)
    assert mesh.psum(x, "dp") is x and torch.equal(mesh.mean(x, "vp"), x.detach())
    # sp builds on two ranks (tests/test_torch_spatial.py); one rank cannot
    # hold an sp = 2 mesh, and a band that would be empty raises
    with pytest.raises(ValueError, match="each of the 1 ranks"):
        make_mesh(n_spatial=2)
    with pytest.raises(ValueError, match="stage height 8 leaves a band empty over sp=2"):
        spatial.row_bands(8, 2)
    with pytest.raises(ValueError, match="each of the 1 ranks"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="must divide the 4 source views"):
        wc.aggregate_cost_volume_view_sharded(
            torch.zeros(1, 5, 8, 8, 8), torch.zeros(1, 5, 2, 4, 4), torch.ones(1, 8),
            Mesh({"dp": 1, "vp": 3, "sp": 1}, {"dp": 0, "vp": 0, "sp": 0}, {},
                 torch.device("cpu")))


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
