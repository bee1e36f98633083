"""BlendedMVS (low-res) dataset with train-time photometric augmentation.

Re-creates reference datasets/blendedmvs.py: metas from per-scene
``cams/pair.txt`` (refs with < nviews-1 sources skipped); train-time
ColorJitter (brightness 0.25, contrast 0.3-1.5) + random motion blur;
mask = rendered depth >= depth_min; base intrinsics are FULL resolution
so the stage pyramid scales x0.25 / x0.5 / x1 (inverted vs DTU);
128 depth planes with the "-0.5" end guard.

A copy of dmvsnet_tpu.data.blendedmvs.
"""

from __future__ import annotations

import os

import cv2
import numpy as np

from dmvsnet_tpu_torch.data import io


def motion_blur(img: np.ndarray, rng: np.random.Generator, max_kernel_size=3):
    """Gaussian-weighted directional blur (reference blendedmvs.py:11-31)."""
    mode = rng.choice(["h", "v", "diag_down", "diag_up"])
    ksize = int(rng.integers(0, (max_kernel_size + 1) // 2)) * 2 + 1
    if ksize <= 1:
        return img
    center = (ksize - 1) // 2
    kernel = np.zeros((ksize, ksize), np.float32)
    if mode == "h":
        kernel[center, :] = 1.0
    elif mode == "v":
        kernel[:, center] = 1.0
    elif mode == "diag_down":
        kernel = np.eye(ksize, dtype=np.float32)
    else:
        kernel = np.flip(np.eye(ksize, dtype=np.float32), 0)
    var = ksize * ksize / 16.0
    grid = np.repeat(np.arange(ksize)[:, None], ksize, axis=-1)
    kernel = kernel * np.exp(
        -((grid - center) ** 2 + (grid.T - center) ** 2) / (2.0 * var)
    )
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def color_jitter(img01: np.ndarray, rng: np.random.Generator):
    """brightness U(0.75,1.25), contrast U(0.3,1.5) about the LUMA mean —
    the torchvision ColorJitter settings at reference blendedmvs.py:45."""
    b = rng.uniform(0.75, 1.25)
    img01 = np.clip(img01 * b, 0, 1)
    c = rng.uniform(0.3, 1.5)
    # torchvision's adjust_contrast blends toward the mean of the ITU-R
    # 601 grayscale (0.299R+0.587G+0.114B), not the per-channel RGB mean
    luma_mean = (img01 @ np.array([0.299, 0.587, 0.114], img01.dtype)).mean()
    return np.clip(luma_mean + (img01 - luma_mean) * c, 0, 1)


class BlendedMVSDataset:
    def __init__(
        self, datapath: str, scans: list[str], nviews: int = 7,
        ndepths: int = 128, interval_scale: float = 1.06, mode: str = "train",
        seed: int = 0,
    ):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.metas = self._build_metas(scans)

    def _build_metas(self, scans):
        metas = []
        for scan in scans:
            pair_path = os.path.join(self.datapath, scan, "cams", "pair.txt")
            for ref, srcs in io.read_pair_file(pair_path):
                if len(srcs) < self.nviews - 1:
                    continue
                metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[: self.nviews - 1]

        imgs, projs = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            img = io.load_image(
                os.path.join(self.datapath, scan, "blended_images", f"{vid:08d}.jpg")
            )
            if self.mode == "train":
                img = motion_blur(color_jitter(img, self.rng), self.rng)
            imgs.append(img)

            intr, extr, depth_line = io.read_cam_file(
                os.path.join(self.datapath, scan, "cams", f"{vid:08d}_cam.txt")
            )
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                dmin = depth_line[0]
                divl = depth_line[1] * self.interval_scale
                depth = io.read_pfm(
                    os.path.join(
                        self.datapath, scan, "rendered_depth_maps", f"{vid:08d}.pfm"
                    )
                )[0].astype(np.float32)
                mask = (depth >= dmin).astype(np.float32)
                h, w = depth.shape

                def pyr(x):
                    return {
                        "stage1": cv2.resize(x, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST),
                        "stage2": cv2.resize(x, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST),
                        "stage3": x,
                    }

                depth_ms, mask_ms = pyr(depth), pyr(mask)
                # "-0.5" guard against the blendedmvs range bug
                # (reference blendedmvs.py:164-166)
                depth_values = np.arange(
                    dmin, divl * (self.ndepths - 0.5) + dmin, divl, dtype=np.float32
                )[: self.ndepths]

        proj = np.stack(projs)
        s1 = proj.copy()
        s1[:, 1, :2, :] *= 0.25
        s2 = proj.copy()
        s2[:, 1, :2, :] *= 0.5
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {"stage1": s1, "stage2": s2, "stage3": proj},
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
        }
