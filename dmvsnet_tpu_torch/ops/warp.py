"""Plane-sweep warp + group correlation in plain PyTorch (port of
dmvsnet_tpu.ops.warp).

For every source view, bilinear-sample its features at the projection of
every (ref pixel, depth hypothesis) and correlate against the reference
features in 2 channel groups; the cost volume is the serial sum over the
source views.  This is the oracle that the CUDA kernel of
``ops/warp_correlate.py`` is held against, and the CPU path of the port.

Layout as in the JAX package: features channels-last (B, H, W, C), cost
volumes (B, D, H, W, G) with G=2, hypotheses (B, D, H, W).
"""

from __future__ import annotations

import torch

from dmvsnet_tpu_torch.core import geometry


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at pixel coords with zero padding.

    Matches ``F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=True)`` in pixel units; out-of-bounds corner taps
    contribute zero.  The 4 taps are summed in the order
    (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1).

    Coordinates are clamped to [-2, W+1] x [-2, H+1] before ``floor``: a
    tap outside the image carries weight 0 either way, so finite
    coordinates give the same result, and huge ones (refine hypotheses can
    be negative or far off) never reach an out-of-range int conversion.

    Args:
      img: (B, H, W, C).
      x, y: (B, ...) equal-shaped pixel coordinates.

    Returns:
      (*x.shape, C) float32.
    """
    b, h, w, c = img.shape
    x = x.float().clamp(-2.0, w + 1.0)
    y = y.float().clamp(-2.0, h + 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()

    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=img.device) * (h * w)).reshape(
        b, *([1] * (x.dim() - 1)))

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, c)
        return vals * (wgt * valid)[..., None]

    return (
        tap(x0i, y0i, (1 - wx) * (1 - wy))
        + tap(x0i + 1, y0i, wx * (1 - wy))
        + tap(x0i, y0i + 1, (1 - wx) * wy)
        + tap(x0i + 1, y0i + 1, wx * wy)
    )


def warp_src_feature(
    src_feat: torch.Tensor,
    src_proj2: torch.Tensor,
    ref_proj2: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """Homography-warp (B, H, W, C) source features over all hypotheses.

    Args:
      src_proj2, ref_proj2: (B, 2, 4, 4) stacked cameras at this stage.
      depth_values: (B, D) or (B, D, H, W).

    Returns:
      (B, D, H, W, C).  The sampling grid carries no gradient.
    """
    _, h, w, _ = src_feat.shape
    rel = geometry.relative_projection(
        geometry.fuse_projection(src_proj2), geometry.fuse_projection(ref_proj2)
    )
    px, py = geometry.plane_sweep_coords(rel, depth_values, h, w)
    return bilinear_sample(src_feat, px.detach(), py.detach())


def group_correlation(
    warped: torch.Tensor, ref_feat: torch.Tensor, groups: int = 2
) -> torch.Tensor:
    """2-group dot-product correlation: group g owns channels {2k+g}
    (k-major interleave); the result is the mean over k of warped*ref.

    Args:
      warped: (B, D, H, W, C); ref_feat: (B, H, W, C).

    Returns:
      (B, D, H, W, groups).
    """
    b, d, h, w, c = warped.shape
    wv = warped.reshape(b, d, h, w, c // groups, groups)
    rv = ref_feat.reshape(b, 1, h, w, c // groups, groups)
    return (wv * rv).mean(dim=-2)


def aggregate_cost_volume(
    features: list[torch.Tensor],
    proj2: torch.Tensor,
    depth_values: torch.Tensor,
    groups: int = 2,
) -> torch.Tensor:
    """Warp every source view and sum the group correlations, in the
    serial view order, accumulating in fp32.

    Args:
      features: per-view list [(B, H, W, C)], index 0 = reference view.
      proj2: (B, V, 2, 4, 4) stacked cameras.
      depth_values: (B, D) or (B, D, H, W).

    Returns:
      (B, D, H, W, groups) cost volume.
    """
    ref_feat = features[0]
    similarity = None
    for v, src_feat in enumerate(features[1:], start=1):
        warped = warp_src_feature(src_feat, proj2[:, v], proj2[:, 0], depth_values)
        corr = group_correlation(warped, ref_feat, groups).float()
        similarity = corr if similarity is None else similarity + corr
    return similarity
