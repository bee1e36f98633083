"""The port's run_test on the CPU vs the JAX run_test on one synthetic scene
(64x96, 3 views, ndepths 8/8/8, inverse depth, eval_batch 2 so the tail
batch is padded, filter_method "none").

Identical weights: the JAX run_test without ``resume`` initialises from
PRNGKey(0); the test records that state as run_test builds it, exports it
with tools/convert_torch_ckpt.export_state_dict, saves it with
torch.save and hands the file to the port's ``resume``.

Tolerances: depth max |diff| <= 0.01 mm, confidence <= 1e-4 (the slice
tolerance of tests/test_torch_slice.py).
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

import dmvsnet_tpu.engine.evaluate as jeval
import dmvsnet_tpu.engine.profiler as jprofiler
from dmvsnet_tpu.config import Config as JConfig
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.engine.evaluate import run_test
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import export_state_dict  # noqa: E402

DEPTH_TOL_MM = 0.01
CONF_TOL = 1e-4
H, W, V = 64, 96, 3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    synthetic.write_eval_scene(str(root / "data"), "scan1", height=H, width=W, n_views=V)
    return root


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX run_test's outputs and the weights it initialised."""
    captured = {}
    real_create = jeval.create_train_state

    def recording_create(*args, **kwargs):
        captured["state"] = real_create(*args, **kwargs)
        return captured["state"]

    def no_summary(*args, **kwargs):  # skip the cost-analysis compile
        raise RuntimeError("skipped in this test")

    mp = pytest.MonkeyPatch()
    mp.setattr(jeval, "create_train_state", recording_create)
    mp.setattr(jprofiler, "model_summary", no_summary)
    try:
        jeval.run_test(JConfig(
            dataset_name="general_eval", datapath=str(scene / "data"), testlist="scan1",
            outdir=str(scene / "jax_out"), ndepths=(8, 8, 8), interval_ratio=(4, 2, 1),
            numdepth=192, max_h=H, max_w=W, num_view=V, inverse_depth=True,
            filter_method="none", eval_batch=2,
        ))
    finally:
        mp.undo()
    state = captured["state"]
    sd = export_state_dict(jax.tree_util.tree_map(np.asarray, state.params),
                           jax.tree_util.tree_map(np.asarray, state.batch_stats))
    path = scene / "jax_init.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


def test_run_test_matches_jax_run_test(scene, jax_run):
    cfg = preset("dtu_test", datapath=str(scene / "data"), testlist="scan1",
                 outdir=str(scene / "port_out"), ndepths=(8, 8, 8), max_h=H, max_w=W,
                 num_view=V, filter_method="none", eval_batch=2, resume=jax_run)
    summary = run_test(cfg, device="cpu")
    assert summary["maps"] == V and len(summary["dispatch_seconds"]) == 2

    for v in range(V):
        name = f"{v:08d}"
        for kind, tol in (("depth_est", DEPTH_TOL_MM), ("confidence", CONF_TOL)):
            ours, _ = io.read_pfm(str(scene / "port_out/scan1" / kind / f"{name}.pfm"))
            ref, _ = io.read_pfm(str(scene / "jax_out/scan1" / kind / f"{name}.pfm"))
            assert ours.shape == (H, W) and np.isfinite(ours).all()
            diff = float(np.max(np.abs(ours - ref)))
            print(f"view {v} {kind}: max |diff| {diff:.3e}")
            assert diff <= tol, (v, kind, diff)
        intr, extr, _ = io.read_cam_file(str(scene / "port_out/scan1/cams" / f"{name}_cam.txt"))
        assert intr.shape == (3, 3) and extr.shape == (4, 4)
        assert os.path.exists(scene / "port_out/scan1/images" / f"{name}.jpg")
