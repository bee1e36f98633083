"""The port's DTU evaluator vs the JAX package's on identical inputs: each
case of tests/test_dtu_eval.py through both packages' ``reduce_points``,
``mask_points_by_obs`` and ``eval_scan``, and ``evaluate_dtu`` over a
synthetic DTU SampleSet through both ``scripts/*dtu_eval.py``.

The copies run the same numpy / scipy code: thinned clouds and masks are
required equal, distances to within 1e-12.
"""

import contextlib
import io as stdio
import os
import runpy
import sys

import numpy as np
import pytest
from scipy.io import savemat

from dmvsnet_tpu.fusion import dtu_eval as jdtu_eval
from dmvsnet_tpu_torch.data.splits import DTU_TEST_IDS
from dmvsnet_tpu_torch.fusion import dtu_eval
from dmvsnet_tpu_torch.fusion.ply import write_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def _grid(n):
    return np.stack(np.meshgrid(*[np.arange(0, n, 1.0)] * 3), -1).reshape(-1, 3)


def _result_fields(r):
    return np.array([r.mean_acc, r.mean_comp, r.median_acc, r.median_comp, r.overall])


def test_reduce_points_equals_the_jax_one(rng):
    pts = rng.uniform(0, 10, size=(2000, 3))
    for density, seed in ((1.0, 0), (0.5, 3)):
        ours = dtu_eval.reduce_points(pts, density, seed)
        np.testing.assert_array_equal(ours, jdtu_eval.reduce_points(pts, density, seed))
        assert len(ours) < len(pts)


def _cases(rng):
    """(name, eval_scan arguments) of tests/test_dtu_eval.py, plus the whole
    chain at once: thinning, mask, plane and cutoff."""
    g = _grid(20)
    g10 = _grid(10)
    mask = np.zeros((11, 11, 11), np.uint8)
    mask[:6] = 1
    bb = np.array([[0.0, 0, 0], [10.0, 10, 10]])
    noisy = g10 + rng.normal(0, 0.3, g10.shape)
    return {
        "known_offset": dict(data_pts=g + np.array([0.3, 0, 0]), stl_pts=g, reduce=False,
                             max_dist=20.0),
        "outlier_cutoff": dict(data_pts=np.concatenate([g10, g10 + np.array([1000.0, 0, 0])]),
                               stl_pts=g10, reduce=False, max_dist=20.0),
        "obs_mask": dict(data_pts=np.concatenate([g10[g10[:, 0] < 5],
                                                  (g10 + 7.7)[g10[:, 0] >= 5]]),
                         stl_pts=g10, obs_mask=mask, bb=bb, res=1.0, reduce=False,
                         max_dist=20.0),
        "ground_plane": dict(data_pts=g10[g10[:, 2] >= 5], stl_pts=g10,
                             ground_plane=np.array([0.0, 0, 1.0, -5.0]), reduce=False),
        "everything": dict(data_pts=noisy, stl_pts=g10, obs_mask=mask, bb=bb, res=1.0,
                           ground_plane=np.array([0.0, 0, 1.0, -2.0]), max_dist=1.0,
                           density=0.5, scan_id=9),
    }


@pytest.mark.parametrize("case", ["known_offset", "outlier_cutoff", "obs_mask",
                                  "ground_plane", "everything"])
def test_eval_scan_equals_the_jax_one(rng, case):
    kw = _cases(rng)[case]
    ours, theirs = dtu_eval.eval_scan(**kw), jdtu_eval.eval_scan(**kw)
    assert ours.scan == theirs.scan and np.isfinite(_result_fields(ours)).all()
    np.testing.assert_allclose(_result_fields(ours), _result_fields(theirs), rtol=0, atol=TOL)
    if case == "known_offset":
        np.testing.assert_allclose(ours.overall, 0.3, atol=1e-6)


def test_obs_mask_equals_the_jax_one_at_cell_boundaries(rng):
    """Random points, exact half-cell offsets and negatives: the MATLAB
    rounding of both packages keeps the same points."""
    res, bb0 = 0.25, np.array([1.0, -2.0, 3.0])
    mask = (rng.uniform(size=(13, 9, 11)) > 0.5).astype(np.uint8)
    pts = np.concatenate([
        bb0 + rng.uniform(-1.5, 4.0, size=(500, 3)),
        bb0 + res * np.array([[0.5, 0.5, 0.5], [1.5, 2.5, 3.5], [-0.5, 0.0, 0.0],
                              [-1.5, 1.0, 1.0]]),
    ])
    bb = np.stack([bb0, bb0 + 10])
    ours = dtu_eval.mask_points_by_obs(pts, mask, bb, res)
    np.testing.assert_array_equal(ours, jdtu_eval.mask_points_by_obs(pts, mask, bb, res))
    assert 0 < ours.sum() < len(pts)


@pytest.fixture
def sampleset(tmp_path, rng):
    """Fused clouds of all 22 DTU test scans beside a SampleSet (STL points,
    ObsMask and Plane .mat files) of a unit cube grid; every third scan has
    no ObsMask and no Plane file."""
    ply_dir, gt_dir = tmp_path / "pcd", tmp_path / "SampleSet"
    stl = _grid(6) * 2.0
    for i, sid in enumerate(DTU_TEST_IDS):
        data = stl[rng.permutation(len(stl))[:150]] + rng.normal(0, 0.4, (150, 3))
        write_ply(str(ply_dir / f"mvsnet{sid:03d}_l3.ply"), data.astype(np.float32),
                  np.zeros((150, 3), np.uint8))
        write_ply(str(gt_dir / "Points" / "stl" / f"stl{sid:03d}_total.ply"),
                  stl.astype(np.float32), np.zeros((len(stl), 3), np.uint8))
        if i % 3:
            os.makedirs(gt_dir / "ObsMask", exist_ok=True)
            savemat(str(gt_dir / "ObsMask" / f"ObsMask{sid}_10.mat"),
                    {"ObsMask": (rng.uniform(size=(6, 6, 6)) > 0.3).astype(np.uint8),
                     "BB": np.array([[0.0, 0, 0], [10.0, 10, 10]]), "Res": np.array([[2.0]])})
            savemat(str(gt_dir / "ObsMask" / f"Plane{sid}.mat"),
                    {"P": np.array([[0.0], [0.0], [1.0], [-1.0 - i % 4]])})
    return str(ply_dir), str(gt_dir)


def test_evaluate_dtu_and_its_script_equal_the_jax_ones(sampleset):
    ply_dir, gt_dir = sampleset
    ours, theirs = dtu_eval.evaluate_dtu(ply_dir, gt_dir), jdtu_eval.evaluate_dtu(ply_dir, gt_dir)
    assert len(ours["per_scan"]) == len(theirs["per_scan"]) == 22
    for a, b in zip(ours["per_scan"], theirs["per_scan"]):
        assert a.scan == b.scan and np.isfinite(_result_fields(a)).all()
        np.testing.assert_allclose(_result_fields(a), _result_fields(b), rtol=0, atol=TOL)
    for k in ("mean_acc", "mean_comp", "overall"):
        assert np.isfinite(ours[k]) and abs(ours[k] - theirs[k]) <= TOL

    def script(name):
        out, argv = stdio.StringIO(), sys.argv
        sys.argv = [name, ply_dir, gt_dir]
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_path(os.path.join(ROOT, "scripts", name), run_name="__main__")
        finally:
            sys.argv = argv
        return out.getvalue()

    printed = script("torch_dtu_eval.py")
    assert printed == script("dtu_eval.py")
    assert printed.count("\n") == 23 and "DTU overall" in printed
