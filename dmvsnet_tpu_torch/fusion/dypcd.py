"""Dynamic-consistency point-cloud fusion (Tanks & Temples protocol).

Re-creates reference filter/dypcd_tanks.py: instead of one threshold
pair, sweep masks_i = (dist < i*dist_base) & (rel_diff < i*rel_diff_base)
for i in [2, 10]; accept a pixel if for some level i at least i source
views pass level i (with dy_range = len(src_views)+1).  Per-view results
(averaged depth PFM + geo mask PNG) are cached on disk so an interrupted
run resumes where it stopped (reference dypcd_tanks.py:221-261).

A copy of dmvsnet_tpu.fusion.dypcd.
"""

from __future__ import annotations

import os
from functools import partial
from multiprocessing import Pool

import cv2
import numpy as np

from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.fusion import geometry_np as G
from dmvsnet_tpu_torch.fusion.pcd import (
    _init_worker,
    load_view,
    photo_mask_for_view,
    save_mask_png,
)
from dmvsnet_tpu_torch.fusion.ply import write_ply
from dmvsnet_tpu_torch.fusion.tank_config import TANK_SCENE_CONFIG


def filter_scan_dynamic(
    pair_folder: str, scan_folder: str, out_folder: str, ply_path: str,
    conf_thresholds=(0.1, 0.15, 0.9), dist_base: float = 0.25,
    rel_diff_base: float = 1.0 / 1300, num_stage: int = 3,
) -> None:
    pair_data = io.read_pair_file(os.path.join(pair_folder, "pair.txt"))
    vertices, colors = [], []

    for ref_view, src_views in pair_data:
        ref_intr, ref_extr, ref_depth = load_view(out_folder, scan_folder, ref_view)
        ref_img = io.load_image(
            os.path.join(scan_folder, f"images/{ref_view:08d}.jpg")
        )
        photo_mask = photo_mask_for_view(out_folder, ref_view, conf_thresholds)

        geo_path = os.path.join(out_folder, f"mask/{ref_view:08d}_geo.png")
        avg_path = os.path.join(out_folder, f"depth_est/{ref_view:08d}_averaged.pfm")
        if os.path.exists(geo_path) and os.path.exists(avg_path):
            geo_mask = cv2.imread(geo_path, -1) > 0
            depth_avg = io.read_pfm(avg_path)[0].astype(np.float32)
        else:
            dy_range = len(src_views) + 1
            levels = list(range(2, dy_range))
            geo_mask_sum = np.zeros(ref_depth.shape, np.int32)
            geo_mask_sums = [np.zeros(ref_depth.shape, np.int32) for _ in levels]
            depth_sum = np.zeros(ref_depth.shape, np.float32)
            xyz_ref = G.ref_rays(ref_depth, ref_intr)  # shared over srcs
            for src_view in src_views:
                src_intr, src_extr, src_depth = load_view(
                    out_folder, scan_folder, src_view
                )
                masks, last_mask, depth_rep = G.check_geometric_consistency_dynamic(
                    ref_depth, ref_intr, ref_extr, src_depth, src_intr, src_extr,
                    dist_base, rel_diff_base, xyz_ref=xyz_ref,
                )
                geo_mask_sum += last_mask.astype(np.int32)
                for j, i in enumerate(levels):
                    geo_mask_sums[j] += masks[i - 2].astype(np.int32)
                depth_sum += depth_rep

            depth_avg = (depth_sum + ref_depth) / (geo_mask_sum + 1)
            io.save_pfm(avg_path, depth_avg.astype(np.float32))
            geo_mask = geo_mask_sum >= dy_range
            for j, i in enumerate(levels):
                geo_mask = geo_mask | (geo_mask_sums[j] >= i)

        final_mask = photo_mask & geo_mask
        save_mask_png(os.path.join(out_folder, f"mask/{ref_view:08d}_photo.png"), photo_mask)
        save_mask_png(geo_path, geo_mask)
        save_mask_png(os.path.join(out_folder, f"mask/{ref_view:08d}_final.png"), final_mask)
        print(
            f"{scan_folder} ref {ref_view:02d} photo/geo/final: "
            f"{photo_mask.mean():.3f}/{geo_mask.mean():.3f}/{final_mask.mean():.3f}"
        )

        h, w = depth_avg.shape
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        xs, ys, ds = x[final_mask], y[final_mask], depth_avg[final_mask]
        stride = {1: 4, 2: 2, 3: 1}[num_stage]
        color = ref_img[1::stride, 1::stride][final_mask] if stride > 1 \
            else ref_img[final_mask]

        uv1 = np.vstack([xs, ys, np.ones_like(xs)]) * ds
        cam_pts = np.linalg.inv(ref_intr) @ uv1
        world = np.linalg.inv(ref_extr) @ np.vstack(
            [cam_pts, np.ones_like(xs, dtype=np.float64)]
        )
        vertices.append(world[:3].T.astype(np.float32))
        colors.append((color * 255).astype(np.uint8))

    write_ply(ply_path, np.concatenate(vertices), np.concatenate(colors))
    print("saved", ply_path)


def _scan_worker(args_dict: dict, scan: str) -> None:
    out_root = args_dict["outdir"]
    conf = tuple(args_dict.get("conf", (0.1, 0.15, 0.9)))
    if scan in TANK_SCENE_CONFIG:
        conf = TANK_SCENE_CONFIG[scan].conf
    save_name = (
        f"mvsnet{int(scan[4:]):03d}_l3.ply"
        if scan.startswith("scan") and scan[4:].isdigit()
        else f"{scan}.ply"
    )
    filter_scan_dynamic(
        pair_folder=os.path.join(args_dict["datapath"], scan),
        scan_folder=os.path.join(out_root, scan),
        out_folder=os.path.join(out_root, scan),
        ply_path=os.path.join(out_root, "pcd", save_name),
        conf_thresholds=conf,
        dist_base=float(args_dict.get("dist_base", 0.25)),
        rel_diff_base=float(args_dict.get("rel_diff_base", 1.0 / 1300)),
        num_stage=int(args_dict.get("num_stage", 3)),
    )


def dypcd_filter(args_dict: dict, scans: list[str], num_workers: int = 1) -> None:
    os.makedirs(os.path.join(args_dict["outdir"], "pcd"), exist_ok=True)
    if num_workers > 1:
        with Pool(num_workers, _init_worker) as pool:
            pool.map(partial(_scan_worker, args_dict), scans)
    else:
        for scan in scans:
            _scan_worker(args_dict, scan)
