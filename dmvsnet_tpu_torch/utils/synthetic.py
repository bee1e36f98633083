"""Synthetic DTU-like batches and scenes for tests / benchmarks / dry runs.

Generates geometrically consistent multi-view inputs: a textured
fronto-parallel plane (or a smooth height-field) at DTU-scale depths
(425-935 mm) rendered into V translated pinhole cameras.  Used where the
real datasets aren't on disk: unit tests and chip_smoke.py.  A copy of
dmvsnet_tpu.utils.synthetic, plus two helpers of the port's own at the end:
``orbit_camera_stack`` (cameras that rotate by degrees about several axes,
as a DTU rig's do) and ``write_blendedmvs_tree``.
"""

from __future__ import annotations

import numpy as np


def camera_stack(fx, fy, cx, cy, tx=0.0, ty=0.0, angle=0.0):
    """A (2,4,4) [extrinsics; intrinsics] stack like the DTU cam.txt."""
    intr = np.zeros((4, 4), np.float32)
    intr[:3, :3] = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    c, s = np.cos(angle), np.sin(angle)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    ext[:3, 3] = [tx, ty, 0.0]
    return np.stack([ext, intr])


def render_plane_views(
    height: int, width: int, n_views: int, depth: float = 600.0,
    seed: int = 0, baseline: float = 12.0,
):
    """Render V views of a textured plane z=depth (ref camera frame).

    Returns (imgs (V,H,W,3) float32 in [0,1], cams (V,2,4,4) at FULL
    resolution intrinsics, gt_depth (H,W) for the ref view).
    """
    rng = np.random.default_rng(seed)
    f = 1.2 * width
    cams = np.stack(
        [camera_stack(f, f, width / 2, height / 2, tx=-baseline * i) for i in range(n_views)]
    )
    # smooth random texture as a Fourier sum
    coeffs = rng.normal(size=(3, 6, 3)).astype(np.float32)

    def texture(X, Y):
        img = np.zeros((*X.shape, 3), np.float32)
        for c in range(3):
            for i in range(6):
                a, fx_, fy_ = coeffs[c, i]
                img[..., c] += np.sin(0.07 * (fx_ * X + fy_ * Y) + a)
        return (img - img.min()) / (img.max() - img.min() + 1e-6)

    xs, ys = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    imgs = []
    for v in range(n_views):
        Kinv = np.linalg.inv(cams[v, 1, :3, :3])
        R, t = cams[v, 0, :3, :3], cams[v, 0, :3, 3]
        rays = np.einsum("ij,jhw->ihw", R.T @ Kinv, np.stack([xs, ys, np.ones_like(xs)]))
        origin = -R.T @ t
        s = (depth - origin[2]) / rays[2]
        imgs.append(texture(origin[0] + s * rays[0], origin[1] + s * rays[1]))
    gt = np.full((height, width), depth, np.float32)
    return np.stack(imgs), cams, gt


def stage_projections(cams_full: np.ndarray, num_stage: int = 3) -> dict:
    """{"stage{i}": (V,2,4,4)} with intrinsics scaled 1/4, 1/2, 1 of full
    (the DTU-train convention, reference datasets/dtu_yao.py:175-185,
    where the base cams are at 1/4 resolution)."""
    out = {}
    for s in range(num_stage):
        scale = 2.0 ** (s - (num_stage - 1))  # 1/4, 1/2, 1
        p = cams_full.copy()
        p[:, 1, :2, :] *= scale
        out[f"stage{s + 1}"] = p
    return out


def write_eval_scene(
    root: str, scan: str = "scan1", height: int = 128, width: int = 160,
    n_views: int = 5, depth: float = 600.0, seed: int = 0,
    baseline: float = 12.0,
) -> None:
    """Materialize a general_eval-format scene directory:
    {scan}/images/*.jpg, {scan}/cams/*_cam.txt, {scan}/pair.txt
    (the layout consumed by reference datasets/general_eval.py:138-142).

    Cam files use FULL-resolution intrinsics x4 (the eval reader divides
    by 4, reference general_eval.py:69)."""
    import os

    from PIL import Image

    from dmvsnet_tpu_torch.data import io as data_io

    imgs, cams, _ = render_plane_views(height, width, n_views, depth, seed,
                                       baseline=baseline)
    scan_dir = os.path.join(root, scan)
    os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(scan_dir, "cams"), exist_ok=True)
    pairs = []
    for v in range(n_views):
        Image.fromarray((imgs[v] * 255).astype(np.uint8)).save(
            os.path.join(scan_dir, "images", f"{v:08d}.jpg"), quality=95
        )
        cam = cams[v].copy()  # eval cam files carry FULL-res intrinsics;
        # the reader's /4 (general_eval.py:69) yields the stage-1 base
        cam[1, 3, :] = [depth - 100.0, 1.5, 192.0, depth - 100.0 + 1.5 * 192]
        data_io.write_cam_file(os.path.join(scan_dir, "cams", f"{v:08d}_cam.txt"), cam)
        pairs.append((v, [s for s in range(n_views) if s != v]))
    data_io.write_pair_file(os.path.join(scan_dir, "pair.txt"), pairs)


def write_dtu_training_tree(
    root: str, scans=("scan1",), n_views: int = 7, height: int = 512,
    width: int = 640, depth: float = 600.0, seed: int = 0,
) -> None:
    """Materialize a miniature DTU-training-format tree:
    Cameras/pair.txt, Cameras/train/*_cam.txt, Rectified/{scan}_train/*.png,
    Depths_raw/{scan}/depth_map_*.pfm + depth_visual_*.png
    (the layout of reference datasets/dtu_yao.py:141-149).

    GT depth/mask are written at 2x target resolution because the reader
    downsamples x2 then center-crops (reference dtu_yao.py:78-95)."""
    import os

    from PIL import Image

    from dmvsnet_tpu_torch.data import io as data_io

    imgs, cams, gt = render_plane_views(height, width, n_views, depth, seed)
    os.makedirs(os.path.join(root, "Cameras/train"), exist_ok=True)
    pairs = []
    for v in range(n_views):
        cam = cams[v].copy()
        cam[1, :3, :] /= 4.0  # DTU-train cams are at 1/4 resolution
        cam[1, 3, :] = [depth - 100.0, (200.0 / 192) / 1.06, 0, 0]
        data_io.write_cam_file(
            os.path.join(root, f"Cameras/train/{v:08d}_cam.txt"), cam
        )
        pairs.append((v, [s for s in range(n_views) if s != v]))
    data_io.write_pair_file(os.path.join(root, "Cameras/pair.txt"), pairs)

    gt2 = np.kron(gt, np.ones((2, 2), np.float32))  # 2x so reader's /2 recovers gt
    for scan in scans:
        rect = os.path.join(root, f"Rectified/{scan}_train")
        draw = os.path.join(root, f"Depths_raw/{scan}")
        os.makedirs(rect, exist_ok=True)
        os.makedirs(draw, exist_ok=True)
        for v in range(n_views):
            for light in range(7):
                Image.fromarray((imgs[v] * 255).astype(np.uint8)).save(
                    os.path.join(rect, f"rect_{v + 1:03d}_{light}_r5000.png")
                )
            data_io.save_pfm(os.path.join(draw, f"depth_map_{v:04d}.pfm"), gt2)
            Image.fromarray(np.full(gt2.shape, 255, np.uint8)).save(
                os.path.join(draw, f"depth_visual_{v:04d}.png")
            )


def make_batch(
    batch: int = 1, n_views: int = 5, height: int = 64, width: int = 96,
    n_depths: int = 48, depth: float = 600.0, seed: int = 0,
) -> dict:
    """A full training batch: imgs/proj pyramid/depth_values/gt/mask."""
    imgs, cams, gt = render_plane_views(height, width, n_views, depth, seed)
    proj = {k: np.broadcast_to(v, (batch, *v.shape)).copy()
            for k, v in stage_projections(cams).items()}
    depth_values = np.linspace(425.0, 935.0, n_depths, dtype=np.float32)
    gt_ms, mask_ms = {}, {}
    for s, scale in [(1, 4), (2, 2), (3, 1)]:
        g = gt[::scale, ::scale]
        gt_ms[f"stage{s}"] = np.broadcast_to(g, (batch, *g.shape)).copy()
        mask_ms[f"stage{s}"] = np.ones((batch, *g.shape), np.float32)
    return {
        "imgs": np.broadcast_to(imgs, (batch, *imgs.shape)).copy(),
        "proj_matrices": proj,
        "depth_values": np.broadcast_to(depth_values, (batch, n_depths)).copy(),
        "depth": gt_ms,
        "mask": mask_ms,
    }


def _rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rz(roll) @ Rx(pitch) @ Ry(yaw), angles in radians."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return rz @ rx @ ry


def orbit_camera_stack(n_views: int, fx: float, fy: float, cx: float, cy: float,
                       depth: float = 600.0, step_deg=(4.0, 2.5, 0.5)) -> np.ndarray:
    """(V, 2, 4, 4) cameras on an arc around the point (0, 0, depth) on the
    reference camera's axis, each turned to look at it.

    View 0 is the reference (identity).  View i sits k = ceil(i/2) steps out,
    on alternate sides: yaw, pitch and roll of +-k * ``step_deg`` degrees
    (about y, x and z), so a view rotates by degrees about several axes as a
    DTU rig's cameras do (4.7 degrees a step by default: baselines of 49 and
    98 mm at depth 600 for the first four sources).  The camera centre is
    ``depth`` from the point along the view's axis."""
    cams = []
    target = np.array([0.0, 0.0, depth])
    for i in range(n_views):
        k = (i + 1) // 2
        sign = 1.0 if i % 2 else -1.0
        yaw, pitch, roll = (np.deg2rad(sign * k * a) for a in step_deg)
        rot = _rotation(yaw, pitch, roll)
        centre = target - depth * rot.T @ np.array([0.0, 0.0, 1.0])
        cam = camera_stack(fx, fy, cx, cy)
        cam[0, :3, :3] = rot
        cam[0, :3, 3] = -rot @ centre
        cams.append(cam)
    return np.stack(cams).astype(np.float32)


def camera_set(kind: str, n_views: int, height: int, width: int, tx: float = -5.0,
               angle: float = 0.01) -> np.ndarray:
    """(V, 2, 4, 4) cameras with focal length 1.2 * width and the principal
    point at the image centre: "translate" (view i at x = ``tx`` * i, turned
    ``angle`` * i rad about y) or "orbit" (``orbit_camera_stack``: rotated by
    degrees about x, y and z, as a DTU rig's cameras are)."""
    f, cx, cy = 1.2 * width, width / 2, height / 2
    if kind == "orbit":
        return orbit_camera_stack(n_views, f, f, cx, cy)
    if kind != "translate":
        raise ValueError(f"camera set {kind!r}: expected 'translate' or 'orbit'")
    return np.stack([camera_stack(f, f, cx, cy, tx=tx * i, angle=angle * i)
                     for i in range(n_views)])


def write_blendedmvs_tree(
    root: str, scan: str = "synthetic_plane", n_views: int = 7, height: int = 576,
    width: int = 768, depth: float = 600.0, seed: int = 0, ndepths: int = 128,
) -> None:
    """Materialize a BlendedMVS-format (low-res) scene of a textured plane:
    {scan}/blended_images/*.jpg, {scan}/cams/*_cam.txt at full-resolution
    intrinsics with the depth line (depth_min, interval, ndepths,
    depth_max) spanning depth +-100..+250 mm, {scan}/cams/pair.txt and
    {scan}/rendered_depth_maps/*.pfm (the layout read by
    data.blendedmvs.BlendedMVSDataset)."""
    import os

    from PIL import Image

    from dmvsnet_tpu_torch.data import io as data_io

    imgs, cams, gt = render_plane_views(height, width, n_views, depth, seed)
    scan_dir = os.path.join(root, scan)
    os.makedirs(os.path.join(scan_dir, "blended_images"), exist_ok=True)
    dmin, dmax = depth - 100.0, depth + 250.0
    pairs = []
    for v in range(n_views):
        Image.fromarray((imgs[v] * 255).astype(np.uint8)).save(
            os.path.join(scan_dir, "blended_images", f"{v:08d}.jpg"), quality=95)
        cam = cams[v].copy()
        cam[1, 3, :] = [dmin, (dmax - dmin) / ndepths, ndepths, dmax]
        data_io.write_cam_file(os.path.join(scan_dir, "cams", f"{v:08d}_cam.txt"), cam)
        # translated views of a fronto-parallel plane all see it at ``depth``
        data_io.save_pfm(os.path.join(scan_dir, "rendered_depth_maps", f"{v:08d}.pfm"), gt)
        pairs.append((v, [s for s in range(n_views) if s != v]))
    data_io.write_pair_file(os.path.join(scan_dir, "cams", "pair.txt"), pairs)
