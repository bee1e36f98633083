"""Point-cloud fusion with fixed geometric thresholds (DTU protocol).

Re-creates reference filter/pcd.py: per reference view, a photometric
mask from per-stage confidence thresholds, a geometric mask from the
project-reproject round trip against every source view (dist < 1 px and
relative depth diff < 1%), depth averaged over consistent views, pixels
kept when >= thres_view source views agree; masked pixels back-projected
to world and concatenated into one binary PLY per scan.

Inputs are the files written by the test runner (depth_est/confidence
PFMs + cams + images), so the pipeline also consumes depth maps produced
by the reference implementation and vice versa.

A copy of dmvsnet_tpu.fusion.pcd.
"""

from __future__ import annotations

import os
import signal
from functools import partial
from multiprocessing import Pool

import numpy as np
from PIL import Image

from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.fusion import geometry_np as G
from dmvsnet_tpu_torch.fusion.ply import write_ply
from dmvsnet_tpu_torch.fusion.tank_config import TANK_SCENE_CONFIG


def save_mask_png(path: str, mask: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((mask.astype(np.uint8)) * 255).save(path)


def load_view(out_folder: str, scan_folder: str, vid: int):
    intr, extr, _ = io.read_cam_file(
        os.path.join(scan_folder, f"cams/{vid:08d}_cam.txt")
    )
    depth = io.read_pfm(os.path.join(out_folder, f"depth_est/{vid:08d}.pfm"))[0]
    return intr, extr, depth.astype(np.float32)


def photo_mask_for_view(out_folder: str, vid: int, conf_thresholds) -> np.ndarray:
    """Per-stage confidence thresholds; stage files optional
    (reference filter/pcd.py:268-274)."""
    conf = io.read_pfm(os.path.join(out_folder, f"confidence/{vid:08d}.pfm"))[0]
    s2_path = os.path.join(out_folder, f"confidence/{vid:08d}_stage2.pfm")
    if os.path.exists(s2_path):
        conf2 = io.read_pfm(s2_path)[0]
        conf1 = io.read_pfm(
            os.path.join(out_folder, f"confidence/{vid:08d}_stage1.pfm")
        )[0]
    else:
        conf2 = conf1 = conf
    return (
        (conf > conf_thresholds[2])
        & (conf2 > conf_thresholds[1])
        & (conf1 > conf_thresholds[0])
    )


def filter_scan(
    pair_folder: str, scan_folder: str, out_folder: str, ply_path: str,
    conf_thresholds=(0.0, 0.0, 0.3), thres_view: int = 5, num_stage: int = 3,
) -> None:
    pair_data = io.read_pair_file(os.path.join(pair_folder, "pair.txt"))
    vertices, colors = [], []

    for ref_view, src_views in pair_data:
        ref_intr, ref_extr, ref_depth = load_view(out_folder, scan_folder, ref_view)
        ref_img = io.load_image(
            os.path.join(scan_folder, f"images/{ref_view:08d}.jpg")
        )
        photo_mask = photo_mask_for_view(out_folder, ref_view, conf_thresholds)

        geo_mask_sum = np.zeros(ref_depth.shape, np.int32)
        depth_sum = np.zeros(ref_depth.shape, np.float32)
        xyz_ref = G.ref_rays(ref_depth, ref_intr)  # shared over src views
        for src_view in src_views:
            src_intr, src_extr, src_depth = load_view(
                out_folder, scan_folder, src_view
            )
            mask, depth_rep = G.check_geometric_consistency(
                ref_depth, ref_intr, ref_extr, src_depth, src_intr, src_extr,
                xyz_ref=xyz_ref,
            )
            geo_mask_sum += mask.astype(np.int32)
            depth_sum += depth_rep

        depth_avg = (depth_sum + ref_depth) / (geo_mask_sum + 1)
        geo_mask = geo_mask_sum >= thres_view
        final_mask = photo_mask & geo_mask

        save_mask_png(os.path.join(out_folder, f"mask/{ref_view:08d}_photo.png"), photo_mask)
        save_mask_png(os.path.join(out_folder, f"mask/{ref_view:08d}_geo.png"), geo_mask)
        save_mask_png(os.path.join(out_folder, f"mask/{ref_view:08d}_final.png"), final_mask)
        print(
            f"{scan_folder} ref {ref_view:02d} photo/geo/final: "
            f"{photo_mask.mean():.3f}/{geo_mask.mean():.3f}/{final_mask.mean():.3f}"
        )

        h, w = depth_avg.shape
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        xs, ys, ds = x[final_mask], y[final_mask], depth_avg[final_mask]
        # depth maps are at 1/4, 1/2 or full image res by stage count
        # (reference filter/pcd.py:333-338)
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
    conf = tuple(args_dict.get("conf", (0.0, 0.0, 0.3)))
    if scan in TANK_SCENE_CONFIG:
        conf = TANK_SCENE_CONFIG[scan].conf
    save_name = (
        f"mvsnet{int(scan[4:]):03d}_l3.ply"  # DTU MATLAB naming
        if scan.startswith("scan") and scan[4:].isdigit()
        else f"{scan}.ply"
    )
    filter_scan(
        pair_folder=os.path.join(args_dict["datapath"], scan),
        scan_folder=os.path.join(out_root, scan),
        out_folder=os.path.join(out_root, scan),
        ply_path=os.path.join(out_root, "pcd", save_name),
        conf_thresholds=conf,
        thres_view=int(args_dict.get("thres_view", 5)),
        num_stage=int(args_dict.get("num_stage", 3)),
    )


def _init_worker():
    signal.signal(signal.SIGINT, signal.SIG_IGN)


def pcd_filter(args_dict: dict, scans: list[str], num_workers: int = 1) -> None:
    """Pool over scans (reference filter/pcd.py:388-410)."""
    os.makedirs(os.path.join(args_dict["outdir"], "pcd"), exist_ok=True)
    if num_workers > 1:
        with Pool(num_workers, _init_worker) as pool:
            pool.map(partial(_scan_worker, args_dict), scans)
    else:
        for scan in scans:
            _scan_worker(args_dict, scan)
