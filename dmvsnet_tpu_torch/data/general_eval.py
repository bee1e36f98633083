"""Generic evaluation dataset (DTU eval / Tanks&Temples / custom scenes).

Re-creates reference datasets/general_eval.py: per-scene pair.txt; src
views padded by repetition when scarce; cam.txt intrinsics divided by 4
(base = 1/4-resolution convention) and 3/4-field depth-line handling
that rescales the interval to ndepths; resolution snapped down to
multiples of 32 within (max_h, max_w) with intrinsics rescale; all views
of a sample resized to a common (h, w); inverse-depth hypothesis fan.

Emits the ``filename`` template "scan/{}/00000000{}" used by the test
writer and fusion (reference general_eval.py:203, model.py:355-380).
"""

from __future__ import annotations

import os

import cv2
import numpy as np

from dmvsnet_tpu_torch.data import io

BASE = 32  # snap resolutions to multiples of 32 (reference general_eval.py:7)


def snap_size(h: int, w: int, max_h: int, max_w: int, base: int = BASE):
    """Largest (h', w') <= (max_h, max_w), multiples of base, preserving
    aspect via the reference's scale rule (general_eval.py:97-106)."""
    if h > max_h or w > max_w:
        scale = max_h / h
        if scale * w > max_w:
            scale = max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base
    return int(new_h), int(new_w)


class GeneralEvalDataset:
    def __init__(
        self, datapath: str, scans: list[str], nviews: int = 5,
        ndepths: int = 192, interval_scale=1.06, max_h: int = 864,
        max_w: int = 1152, fix_res: bool = False, inverse_depth: bool = False,
        fixed_hw: tuple[int, int] | None = None,
    ):
        """interval_scale may be a float or a per-scan dict (float fallback
        via .get is NOT applied — a dict must cover every scan, like the
        reference's interval_scale_dict, general_eval.py:30-37).

        fixed_hw: resolution latched by a PREVIOUS dataset's fix_res.  The
        reference keeps the latch in module globals (general_eval.py:7-8,
        150-154) so it survives the fresh per-scene dataset of
        model.py:330; here the runner threads ``ds.latched_hw`` into the
        next scene's constructor explicitly.
        """
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h, self.max_w = max_h, max_w
        self.fix_res = fix_res
        self.inverse_depth = inverse_depth
        if isinstance(interval_scale, float):
            self.interval_scale = {s: interval_scale for s in scans}
        else:
            self.interval_scale = interval_scale
        self.metas = self._build_metas(scans)
        self._fixed_hw: tuple[int, int] | None = fixed_hw

    @property
    def latched_hw(self) -> tuple[int, int] | None:
        """The (h, w) latched by fix_res, for threading across scenes."""
        return self._fixed_hw

    def _build_metas(self, scans):
        metas = []
        for scan in scans:
            pairs = io.read_pair_file(os.path.join(self.datapath, scan, "pair.txt"))
            for ref, srcs in pairs:
                if len(srcs) < self.nviews - 1:
                    srcs = srcs + [srcs[0]] * (self.nviews - len(srcs))
                metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, scan, vid):
        intr, extr, depth_line = io.read_cam_file(
            os.path.join(self.datapath, scan, "cams", f"{vid:08d}_cam.txt")
        )
        intr = intr.copy()
        intr[:2, :] /= 4.0
        depth_min = depth_line[0]
        depth_interval = depth_line[1]
        if len(depth_line) >= 3:
            depth_max = depth_min + int(depth_line[2]) * depth_interval
            depth_interval = (depth_max - depth_min) / self.ndepths
        depth_interval *= self.interval_scale[scan]
        return intr, extr, depth_min, depth_interval

    def _load_view(self, scan, vid):
        path = os.path.join(self.datapath, scan, "images_post", f"{vid:08d}.jpg")
        if not os.path.exists(path):
            path = os.path.join(self.datapath, scan, "images", f"{vid:08d}.jpg")
        return io.load_image(path)

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[: self.nviews - 1]

        imgs, projs = [], []
        depth_values = None
        sample_hw = self._fixed_hw
        for i, vid in enumerate(view_ids):
            img = self._load_view(scan, vid)
            intr, extr, dmin, divl = self._read_cam(scan, vid)

            h, w = img.shape[:2]
            nh, nw = snap_size(h, w, self.max_h, self.max_w)
            intr[0, :] *= nw / w
            intr[1, :] *= nh / h
            img = cv2.resize(img, (nw, nh))

            if sample_hw is None:
                sample_hw = (nh, nw)
                if self.fix_res:
                    self._fixed_hw = sample_hw
            if (nh, nw) != sample_hw:
                sh, sw = sample_hw
                intr[0, :] *= sw / nw
                intr[1, :] *= sh / nh
                img = cv2.resize(img, (sw, sh))

            imgs.append(img)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                if self.inverse_depth:
                    dend = divl * self.ndepths + dmin
                    inv = np.linspace(
                        1.0 / dmin, 1.0 / dend, self.ndepths, endpoint=False
                    )
                    depth_values = (1.0 / inv).astype(np.float32)
                else:
                    depth_values = np.arange(
                        dmin, divl * (self.ndepths - 0.5) + dmin, divl,
                        dtype=np.float32,
                    )[: self.ndepths]

        proj = np.stack(projs)
        s2 = proj.copy()
        s2[:, 1, :2, :] *= 2
        s3 = proj.copy()
        s3[:, 1, :2, :] *= 4
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {"stage1": proj, "stage2": s2, "stage3": s3},
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
