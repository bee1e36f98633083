"""Vectorized numpy geometry for depth-map fusion (host-side, per scene).

The project→sample→reproject round trip between a reference and a source
depth map (reference filter/pcd.py:96-242), fully vectorized: no per-pair
GPU round trips, one batched evaluation per view pair.  Runs in worker
processes of the fusion pool.

A copy of dmvsnet_tpu.fusion.geometry_np.
"""

from __future__ import annotations

import numpy as np


def bilinear_sample_np(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Zero-padded bilinear sampling of (H, W) at float pixel coords —
    same semantics as ops.warp.bilinear_sample (align_corners=True)."""
    h, w = img.shape
    x0 = np.floor(x)
    y0 = np.floor(y)
    wx = (x - x0).astype(np.float32)
    wy = (y - y0).astype(np.float32)
    x0i = x0.astype(np.int32)
    y0i = y0.astype(np.int32)
    flat = np.ascontiguousarray(img, np.float32).ravel()
    out = np.zeros(x.shape, np.float32)
    for dx, dy, wgt in (
        (0, 0, (1 - wx) * (1 - wy)),
        (1, 0, wx * (1 - wy)),
        (0, 1, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        xi = x0i + dx
        yi = y0i + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)
        np.multiply(wgt, valid, out=wgt)
        out += flat.take(idx.ravel()).reshape(x.shape) * wgt
    return out


def ref_rays(depth_ref: np.ndarray, intr_ref: np.ndarray) -> np.ndarray:
    """(3, H*W) float32 back-projected ref points inv(K) @ (u, v, 1) * d —
    shared across all source views of one reference (filter_scan caches
    it: ~1/3 of the per-pair matrix work)."""
    h, w = depth_ref.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    uv1 = np.empty((3, h * w), np.float32)
    uv1[0] = x.ravel()
    uv1[1] = y.ravel()
    uv1[2] = 1.0
    return np.linalg.inv(intr_ref).astype(np.float32) @ (
        uv1 * np.asarray(depth_ref, np.float32).reshape(-1)
    )


def reproject_with_depth(
    depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
    xyz_ref: np.ndarray | None = None,
):
    """Project ref pixels into src, sample src depth, lift back into ref.

    Returns (depth_reprojected, x_reprojected, y_reprojected) — the
    quantities the consistency check needs (reference filter/pcd.py:152-200).
    """
    h, w = depth_ref.shape
    # big per-pixel arrays stay float32 (the reference computes in torch
    # fp32, filter/pcd.py:152-200); the 3x3/4x4 inverses stay float64
    if xyz_ref is None:
        xyz_ref = ref_rays(depth_ref, intr_ref)
    rel = (extr_src @ np.linalg.inv(extr_ref)).astype(np.float32)
    xyz_src = rel[:3, :3] @ xyz_ref + rel[:3, 3:4]
    k_src = intr_src.astype(np.float32) @ xyz_src
    xy_src = k_src[:2] / k_src[2:3]

    # sample src depth at projected coords, lift back into ref frame
    sampled = bilinear_sample_np(
        depth_src, xy_src[0].reshape(h, w), xy_src[1].reshape(h, w)
    )
    uv1_src = np.empty((3, h * w), np.float32)
    uv1_src[:2] = xy_src
    uv1_src[2] = 1.0
    xyz_src2 = np.linalg.inv(intr_src).astype(np.float32) @ (
        uv1_src * sampled.reshape(-1)
    )
    rel_back = (extr_ref @ np.linalg.inv(extr_src)).astype(np.float32)
    xyz_rep = rel_back[:3, :3] @ xyz_src2 + rel_back[:3, 3:4]
    depth_rep = xyz_rep[2].reshape(h, w)
    k_rep = intr_ref.astype(np.float32) @ xyz_rep
    z = k_rep[2:3]
    z = np.where(z == 0, z + 1e-5, z)
    xy_rep = k_rep[:2] / z
    return (
        depth_rep,
        xy_rep[0].reshape(h, w),
        xy_rep[1].reshape(h, w),
    )


def check_geometric_consistency(
    depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
    dist_thresh: float = 1.0, rel_diff_thresh: float = 0.01,
    xyz_ref: np.ndarray | None = None,
):
    """Single-threshold check (reference filter/pcd.py:226-242):
    reprojection distance < dist_thresh px AND relative depth diff <
    rel_diff_thresh.  Returns (mask, depth_reprojected_masked)."""
    h, w = depth_ref.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    depth_rep, x_rep, y_rep = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
        xyz_ref=xyz_ref,
    )
    dist = np.sqrt((x_rep - x) ** 2 + (y_rep - y) ** 2)
    safe_ref = np.where(depth_ref == 0, 1e-4, depth_ref)
    rel_diff = np.abs(depth_rep - safe_ref) / safe_ref
    mask = (dist < dist_thresh) & (rel_diff < rel_diff_thresh)
    return mask, np.where(mask, depth_rep, 0.0)


def check_geometric_consistency_dynamic(
    depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
    dist_base: float, rel_diff_base: float, levels=range(2, 11),
    xyz_ref: np.ndarray | None = None,
):
    """The dypcd sweep (reference filter/dypcd_tanks.py:164-184): masks_i
    for thresholds (i*dist_base, i*rel_diff_base), i in [2, 10].  Returns
    (list of masks, last mask, masked reprojected depth)."""
    h, w = depth_ref.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    depth_rep, x_rep, y_rep = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
        xyz_ref=xyz_ref,
    )
    dist = np.sqrt((x_rep - x) ** 2 + (y_rep - y) ** 2)
    safe_ref = np.where(depth_ref == 0, 1e-4, depth_ref)
    rel_diff = np.abs(depth_rep - safe_ref) / safe_ref
    masks = [
        (dist < i * dist_base) & (rel_diff < i * rel_diff_base) for i in levels
    ]
    last = masks[-1]
    return masks, last, np.where(last, depth_rep, 0.0)
