"""DTU benchmark evaluation in Python (MATLAB-protocol equivalent).

Re-creates the official evaluator shipped with the reference
(reference scripts/evaluation_dtu/*.m) without MATLAB:

* point clouds thinned to >= ``density`` (0.2 mm) min spacing
  (reducePts_haa.m — stochastic order, grid-hash neighborhood test);
* accuracy  = distances data -> STL, cutoff ``max_dist`` (20 mm),
  data points filtered by the scan's ObsMask (BaseEvalMain_web.m:60-64);
* completeness = distances STL -> data, StlAbovePlane filter
  (PointCompareMain.m:40-55);
* per-scan mean acc / mean comp; overall = (mean acc + mean comp) / 2
  over the 22 eval scans (ComputeStat_web.m:93-96).

Nearest-neighbor queries use scipy cKDTree (the MATLAB code's chunked
KD-tree, MaxDistCP.m, exists only to bound MATLAB memory).

Ground-truth inputs are the official DTU "SampleSet/ObsMask" .mat files
and "Points/stl" STL point clouds; pass their locations explicitly.

A copy of dmvsnet_tpu.fusion.dtu_eval.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy.spatial import cKDTree


def reduce_points(pts: np.ndarray, density: float, seed: int = 0) -> np.ndarray:
    """Random-order thinning: keep a point if no already-kept point lies
    within ``density`` — equivalent to reducePts_haa.m's greedy
    kill-the-neighbourhood in random order (a point survives iff no
    earlier-kept point is within dst; rangesearch is <=, hence <= here)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pts))
    pts_o = pts[order]
    cell = density
    grid: dict[tuple[int, int, int], list[int]] = {}
    kept_mask = np.zeros(len(pts_o), bool)
    kept_pts = []
    d2 = density * density
    keys = np.floor(pts_o / cell).astype(np.int64)
    for i in range(len(pts_o)):
        kx, ky, kz = keys[i]
        p = pts_o[i]
        ok = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((kx + dx, ky + dy, kz + dz), ()):
                        q = kept_pts[j]
                        if ((p - q) ** 2).sum() <= d2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault((kx, ky, kz), []).append(len(kept_pts))
            kept_pts.append(p)
            kept_mask[i] = True
    return pts_o[kept_mask]


def _matlab_round(x: np.ndarray) -> np.ndarray:
    """MATLAB round: halves away from zero (numpy rounds halves to even)."""
    return np.trunc(x + np.copysign(0.5, x))


def mask_points_by_obs(pts: np.ndarray, obs_mask: np.ndarray, bb: np.ndarray,
                       res: float) -> np.ndarray:
    """Keep data points inside the scan's observability mask.

    PointCompareMain.m:33-41: ``Qv = round((Qdata - BB(1,:))/Res + 1)``,
    valid when 1 <= Qv <= size(ObsMask) (1-based).  The mask's 10 mm
    margin is baked into the shipped ObsMask{set}_10.mat volume — it does
    NOT enter the quantization.  Rounding follows MATLAB (halves away
    from zero).
    """
    # literal 1-based form then shift: the +1 matters at the -0.5 cell
    # boundary (round(0.5) = 1 -> index 0, where round(-0.5) would be -1)
    idx = (_matlab_round((pts - bb[0]) / res + 1.0) - 1.0).astype(np.int64)
    in_bounds = np.all((idx >= 0) & (idx < np.array(obs_mask.shape)), axis=1)
    keep = np.zeros(len(pts), bool)
    ib = idx[in_bounds]
    keep[in_bounds] = obs_mask[ib[:, 0], ib[:, 1], ib[:, 2]] > 0
    return keep


@dataclass
class ScanResult:
    scan: int
    mean_acc: float
    mean_comp: float
    median_acc: float
    median_comp: float

    @property
    def overall(self) -> float:
        return 0.5 * (self.mean_acc + self.mean_comp)


def eval_scan(
    data_pts: np.ndarray,
    stl_pts: np.ndarray,
    obs_mask: np.ndarray | None = None,
    bb: np.ndarray | None = None,
    res: float = 0.2,
    ground_plane: np.ndarray | None = None,
    max_dist: float = 20.0,
    density: float = 0.2,
    scan_id: int = 0,
    reduce: bool = True,
) -> ScanResult:
    """Accuracy/completeness of one scan (PointCompareMain.m)."""
    if reduce and len(data_pts):
        data_pts = reduce_points(data_pts, density)

    # accuracy: data -> stl, filter by observability mask
    acc_pts = data_pts
    if obs_mask is not None and bb is not None and len(acc_pts):
        acc_pts = acc_pts[mask_points_by_obs(acc_pts, obs_mask, bb, res)]
    if len(acc_pts):
        d_acc, _ = cKDTree(stl_pts).query(acc_pts, k=1)
        d_acc = d_acc[d_acc < max_dist]
    else:
        d_acc = np.array([np.nan])

    # completeness: stl -> data, filter stl by above-plane
    comp_pts = stl_pts
    if ground_plane is not None:
        above = comp_pts @ ground_plane[:3] + ground_plane[3] > 0
        comp_pts = comp_pts[above]
    if len(data_pts):
        d_comp, _ = cKDTree(data_pts).query(comp_pts, k=1)
        d_comp = d_comp[d_comp < max_dist]
    else:
        d_comp = np.full(len(comp_pts), max_dist)

    return ScanResult(
        scan=scan_id,
        mean_acc=float(np.mean(d_acc)),
        mean_comp=float(np.mean(d_comp)),
        median_acc=float(np.median(d_acc)),
        median_comp=float(np.median(d_comp)),
    )


def load_obs_mask(mat_path: str):
    """ObsMask{scan}_10.mat -> (mask volume, bounding box (2,3), res)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    return m["ObsMask"], np.asarray(m["BB"], np.float64), float(np.ravel(m["Res"])[0])


def load_ground_plane(mat_path: str) -> np.ndarray:
    from scipy.io import loadmat

    return np.ravel(loadmat(mat_path)["P"]).astype(np.float64)


def evaluate_dtu(
    ply_dir: str, gt_dir: str, scan_ids=None, density: float = 0.2,
    max_dist: float = 20.0,
) -> dict:
    """Full DTU protocol over the eval scans (ComputeStat_web.m).

    Args:
      ply_dir: directory with mvsnet{scan:03d}_l3.ply files (our fusion output).
      gt_dir: DTU SampleSet root containing ObsMask/ and Points/stl/.
    """
    from dmvsnet_tpu_torch.data.splits import DTU_TEST_IDS
    from dmvsnet_tpu_torch.fusion.ply import read_ply

    scan_ids = scan_ids or DTU_TEST_IDS
    results = []
    for sid in scan_ids:
        data_pts, _ = read_ply(os.path.join(ply_dir, f"mvsnet{sid:03d}_l3.ply"))
        stl_pts, _ = read_ply(
            os.path.join(gt_dir, "Points", "stl", f"stl{sid:03d}_total.ply")
        )
        obs_mask = bb = plane = None
        res = 0.2
        obs_path = os.path.join(gt_dir, "ObsMask", f"ObsMask{sid}_10.mat")
        if os.path.exists(obs_path):
            obs_mask, bb, res = load_obs_mask(obs_path)
        plane_path = os.path.join(gt_dir, "ObsMask", f"Plane{sid}.mat")
        if os.path.exists(plane_path):
            plane = load_ground_plane(plane_path)
        r = eval_scan(
            data_pts.astype(np.float64), stl_pts.astype(np.float64),
            obs_mask, bb, res, plane, max_dist, density, sid,
        )
        print(f"scan{sid}: acc {r.mean_acc:.4f} comp {r.mean_comp:.4f} "
              f"overall {r.overall:.4f}", flush=True)
        results.append(r)

    mean_acc = float(np.mean([r.mean_acc for r in results]))
    mean_comp = float(np.mean([r.mean_comp for r in results]))
    summary = {
        "mean_acc": mean_acc,
        "mean_comp": mean_comp,
        "overall": 0.5 * (mean_acc + mean_comp),
        "per_scan": results,
    }
    print(f"DTU overall: {summary['overall']:.4f} mm "
          f"(acc {mean_acc:.4f} / comp {mean_comp:.4f})", flush=True)
    return summary
