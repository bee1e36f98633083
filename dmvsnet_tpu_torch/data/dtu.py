"""DTU training dataset (Yao Yao preprocessing): host-side numpy pipeline,
a copy of dmvsnet_tpu.data.dtu.

Re-creates reference datasets/dtu_yao.py: metas are scans x 49 ref views
(Cameras/pair.txt) x 7 light conditions; images come rectified at
640x512; ground-truth depth/mask come at 1600x1200 and are downsampled
x2 (nearest) then center-cropped to 512x640; per-stage pyramids at 1/4,
1/2, 1 nearest; 192 uniformly spaced depth values from the cam file's
(depth_min, depth_interval x interval_scale).

Output sample dict (channels-last):
  imgs (V, H, W, 3) f32 | proj_matrices {stage: (V, 2, 4, 4)}
  depth {stage: (h, w)} | mask {stage: (h, w)} | depth_values (D0,)
"""

from __future__ import annotations

import os

import cv2
import numpy as np

from dmvsnet_tpu_torch.data import io


def _nearest_pyramid(img: np.ndarray) -> dict[str, np.ndarray]:
    h, w = img.shape
    return {
        "stage1": cv2.resize(img, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST),
        "stage2": cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST),
        "stage3": img,
    }


def _stage_projections(proj: np.ndarray) -> dict[str, np.ndarray]:
    """Base cams are at 1/4 resolution: stage2 x2, stage3 x4
    (reference datasets/dtu_yao.py:175-185)."""
    s2 = proj.copy()
    s2[:, 1, :2, :] *= 2
    s3 = proj.copy()
    s3[:, 1, :2, :] *= 4
    return {"stage1": proj, "stage2": s2, "stage3": s3}


class DTUTrainDataset:
    def __init__(
        self, datapath: str, scans: list[str], nviews: int = 5,
        ndepths: int = 192, interval_scale: float = 1.06,
        img_size=(512, 640), mode: str = "train",
    ):
        if img_size[0] % 32 or img_size[1] % 32:
            raise ValueError(f"img_size {img_size} must be multiples of 32")
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.img_size = tuple(img_size)
        self.mode = mode
        self.metas = self._build_metas(scans)

    def _build_metas(self, scans):
        metas = []
        pair_path = os.path.join(self.datapath, "Cameras/pair.txt")
        pairs = io.read_pair_file(pair_path)
        for scan in scans:
            for ref, srcs in pairs:
                for light in range(7):
                    metas.append((scan, light, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, vid):
        path = os.path.join(self.datapath, f"Cameras/train/{vid:08d}_cam.txt")
        intr, extr, depth_line = io.read_cam_file(path)
        depth_min = depth_line[0]
        depth_interval = depth_line[1] * self.interval_scale
        return intr, extr, depth_min, depth_interval

    def _prepare_hr(self, img: np.ndarray) -> np.ndarray:
        """1600x1200 -> x0.5 nearest -> center crop to img_size
        (reference datasets/dtu_yao.py:78-95)."""
        h, w = img.shape
        img = cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
        h, w = img.shape
        th, tw = self.img_size
        sh, sw = (h - th) // 2, (w - tw) // 2
        return img[sh : sh + th, sw : sw + tw]

    def __getitem__(self, idx):
        scan, light, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[: self.nviews - 1]

        imgs, projs = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.datapath,
                f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light}_r5000.png",
            )
            imgs.append(io.load_image(img_path))
            intr, extr, dmin, divl = self._read_cam(vid)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                depth_hr = io.read_pfm(
                    os.path.join(self.datapath, f"Depths_raw/{scan}/depth_map_{vid:04d}.pfm")
                )[0].astype(np.float32)
                mask_hr = (
                    io.load_image(
                        os.path.join(
                            self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:04d}.png"
                        )
                    )
                    * 255.0
                    > 10
                ).astype(np.float32)
                if mask_hr.ndim == 3:
                    mask_hr = mask_hr[..., 0]
                depth_ms = _nearest_pyramid(self._prepare_hr(depth_hr))
                mask_ms = _nearest_pyramid(self._prepare_hr(mask_hr))
                depth_values = (
                    dmin + np.arange(self.ndepths, dtype=np.float32) * divl
                )

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": _stage_projections(np.stack(projs)),
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
        }
