"""Epipolar rectification for 1-D plane sweeps (closed form, plain torch;
port of dmvsnet_tpu.core.epipolar), batched over a leading pair dimension.

For a (ref, src) pair with fused relative projection ``rel`` (the matrix
the plane sweep uses, core/geometry.relative_projection), the projected
source position of ref pixel h at depth d is q(d) ~ M h + t/d with
M = rel[:3,:3], t = rel[:3,3].  All q(d) lie on the epipolar line through
the epipole e ~ t.  A homography H0 that maps e to the horizontal point at
infinity makes every epipolar line a scanline; the matched pair
(H_src = S_src H0, H_ref = S_ref H0 M) with a shared vertical similarity
puts corresponding pixels on the same row:

  rect-ref pixel h_hat = proj(S_ref H0 M h)
  match at depth d:      x = px_inf(h_hat) + b(h_hat) / d,  y = y_hat
  px_inf(h_hat) = (s_xs / s_xr) x_hat + const          (affine, exact)
  b(h_hat)      = s_xs * w0 * (g . (x_hat, y_hat, 1))  (affine, exact)

with w = H0 t = (w0, 0, 0) by construction and g = row 3 of
(S_ref H0 M)^{-1}.  With inverse-depth-uniform hypotheses the whole
coordinate field is px(d) = P0 + d * P1: two per-pixel maps for all planes.

The sweep then needs one 2-D resample per view (rectification) instead of
one per (view, plane); the per-plane work is a 1-D lerp along the scanline;
the cost volume is computed on the rect grid and un-rectified once.  This
is an approximation of the direct per-pixel sweep: the two resamples
low-pass the features and blend the checkerboard hypothesis offsets.

Every function takes N pairs at once (``rel`` (N, 3|4, 4), maps (N, H, W)):
the JAX package loops over batch and view in Python, which on a GPU is a
chain of tiny launches per pair.  The 3x3 products are elementwise fp32
(core/geometry._matmul): a reduced-precision product here shifts the
rectified rows (the JAX package measured 0.25 rows).

Every function works on the device of the tensors it is given.  The 3x3
work (compute_rectification with its inverses) is a few hundred tiny
operations, each a launch on a GPU; the Rectification carries the two
inverse homographies so that a caller may compute it on CPU tensors, move
it to the card once and build the (N, H, W) maps there without another
inverse (ops/epipolar_sweep.py does, from a measurement).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvsnet_tpu_torch.core.geometry import _matmul, inv3
from dmvsnet_tpu_torch.ops import warp


class Rectification(NamedTuple):
    h_ref: torch.Tensor     # (N, 3, 3) ref pixel -> rect grid
    h_src: torch.Tensor     # (N, 3, 3) src pixel -> rect grid
    px_aff: torch.Tensor    # (N, 3) px_inf = px_aff . (x_hat, y_hat, 1)
    b_aff: torch.Tensor     # (N, 3) b      = b_aff  . (x_hat, y_hat, 1)
    # diagnostics for validity gating
    epipole_dist: torch.Tensor  # (N,) epipole distance from the src image centre (px)
    scales: torch.Tensor        # (N, 3) (s_xr, s_xs, s_y) rect scale factors
    # the inverses (rect grid -> pixel), beyond the JAX package's fields
    h_ref_inv: torch.Tensor     # (N, 3, 3)
    h_src_inv: torch.Tensor     # (N, 3, 3)

    def to(self, device) -> "Rectification":
        return Rectification(*(t.to(device) for t in self))

    def select(self, pairs: torch.Tensor) -> "Rectification":
        """The Rectification of a subset of the pairs."""
        return Rectification(*(t[pairs] for t in self))


def apply_h(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Homographies (..., 3, 3) applied to pixel coords -> (x', y').  x and
    y carry m's leading dimensions (or 1 there), then any further ones."""
    e = m.reshape(*m.shape[:-2], *([1] * (x.dim() - (m.dim() - 2))), 3, 3)
    d = e[..., 2, 0] * x + e[..., 2, 1] * y + e[..., 2, 2]
    d = torch.where(d == 0.0, d + 1e-9, d)
    return (
        (e[..., 0, 0] * x + e[..., 0, 1] * y + e[..., 0, 2]) / d,
        (e[..., 1, 0] * x + e[..., 1, 1] * y + e[..., 1, 2]) / d,
    )


def _mat3(like: torch.Tensor, rows) -> torch.Tensor:
    """(N, 3, 3) from a 3x3 nest of (N,) tensors and Python numbers."""
    return torch.stack([
        torch.stack([e if torch.is_tensor(e) else torch.full_like(like, e) for e in row], dim=-1)
        for row in rows], dim=-2)


def pixel_grid(height: int, width: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates (gx, gy), each (1, H, W)."""
    gy = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]
    gx = torch.arange(width, dtype=torch.float32, device=device)[None, None, :]
    return gx.expand(1, height, width), gy.expand(1, height, width)


def compute_rectification(rel: torch.Tensor, height: int, width: int) -> Rectification:
    """Matched rectifying homographies for N (ref, src) pairs, ``rel``
    (N, 3|4, 4).

    The rect grid reuses the (height, width) shape: the ref content is
    similarity-fitted to it exactly; the src side shares the vertical fit
    (rows must align) and fits its own horizontal span.
    """
    rel = rel.float()
    m = rel[:, :3, :3]
    t = rel[:, :3, 3]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0

    # epipole in src pixels; direction from the image centre
    ez = torch.where(t[:, 2].abs() < 1e-12, torch.full_like(t[:, 2], 1e-12), t[:, 2])
    ex, ey = t[:, 0] / ez, t[:, 1] / ez
    dx, dy = ex - cx, ey - cy
    f = torch.sqrt(dx * dx + dy * dy).clamp_min(1e-6)
    ct, st = dx / f, dy / f

    trans = _mat3(f, [[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    rot = _mat3(f, [[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    g = _mat3(f, [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0 / f, 0.0, 1.0]])
    h0 = _matmul(g, _matmul(rot, trans))

    hr0 = _matmul(h0, m)  # ref -> raw rect
    corners_x = torch.tensor([0.0, width - 1.0, 0.0, width - 1.0], device=rel.device)[None]
    corners_y = torch.tensor([0.0, 0.0, height - 1.0, height - 1.0], device=rel.device)[None]
    xr, yr = apply_h(hr0, corners_x, corners_y)
    xs, _ = apply_h(h0, corners_x, corners_y)

    # shared vertical fit (ref content drives it), per-side horizontal fit
    yr_min, xr_min, xs_min = yr.amin(1), xr.amin(1), xs.amin(1)
    sy = (height - 1.0) / (yr.amax(1) - yr_min).clamp_min(1e-6)
    ty = -yr_min * sy
    sxr = (width - 1.0) / (xr.amax(1) - xr_min).clamp_min(1e-6)
    txr = -xr_min * sxr
    sxs = (width - 1.0) / (xs.amax(1) - xs_min).clamp_min(1e-6)
    txs = -xs_min * sxs

    s_ref = _mat3(f, [[sxr, 0.0, txr], [0.0, sy, ty], [0.0, 0.0, 1.0]])
    s_src = _mat3(f, [[sxs, 0.0, txs], [0.0, sy, ty], [0.0, 0.0, 1.0]])

    h_ref = _matmul(s_ref, hr0)
    h_src = _matmul(s_src, h0)

    # px_inf(h_hat) affine: proj_x(S_src S_ref^{-1} h_hat)
    px_aff = _matmul(s_src, inv3(s_ref))[:, 0]
    # b(h_hat) = sxs * w0 * (row 3 of h_ref^{-1}) . h_hat
    w0 = (h0[:, 0] * t).sum(-1)
    h_ref_inv = inv3(h_ref)
    b_aff = (sxs * w0)[:, None] * h_ref_inv[:, 2]

    return Rectification(h_ref=h_ref, h_src=h_src, px_aff=px_aff, b_aff=b_aff,
                         epipole_dist=f, scales=torch.stack([sxr, sxs, sy], dim=-1),
                         h_ref_inv=h_ref_inv, h_src_inv=inv3(h_src))


def rect_grid_coords(h: torch.Tensor, height: int, width: int):
    """Inverse-map coords for resampling onto the rect grid: for each rect
    pixel (x_hat, y_hat), where to sample the original image.  h (N, 3, 3)
    -> (px, py), each (N, H, W).  With a Rectification at hand,
    ``apply_h(rect.h_ref_inv, *pixel_grid(...))`` is the same without the
    inverse."""
    return apply_h(inv3(h), *pixel_grid(height, width, h.device))


def unrect_grid_coords(h: torch.Tensor, height: int, width: int):
    """Forward-map coords for resampling back to the original grid: for
    each original pixel, where it lives on the rect grid."""
    return apply_h(h, *pixel_grid(height, width, h.device))


def affine_maps(rect: Rectification, height: int, width: int):
    """The affine maps px_inf and b of the rect grid, each (N, H, W)."""
    gx, gy = pixel_grid(height, width, rect.px_aff.device)
    pa, ba = (t[:, :, None, None] for t in (rect.px_aff, rect.b_aff))
    return pa[:, 0] * gx + pa[:, 1] * gy + pa[:, 2], ba[:, 0] * gx + ba[:, 1] * gy + ba[:, 2]


def sweep_coeff_maps(rect: Rectification, inv_lo: torch.Tensor, inv_step: torch.Tensor,
                     height: int, width: int):
    """Per-rect-pixel (P0, P1) with px(d) = P0 + d * P1 for plane index d.

    Args:
      rect: the pairs' Rectification.
      inv_lo, inv_step: (N, H, W) per-original-pixel inverse-depth fan
        coefficients (1/depth(d) = inv_lo + d * inv_step); resampled onto
        the rect grid here with the ref homography.
    """
    sx, sy = rect_grid_coords(rect.h_ref, height, width)
    coeffs = warp.bilinear_sample(torch.stack([inv_lo, inv_step], dim=-1), sx, sy)
    px_inf, b = affine_maps(rect, height, width)
    return px_inf + b * coeffs[..., 0], b * coeffs[..., 1]


def rectified_sweep_corr(
    src_feat: torch.Tensor,
    ref_feat: torch.Tensor,
    rel: torch.Tensor,
    inv_lo: torch.Tensor,
    inv_step: torch.Tensor,
    ndepth: int,
    groups: int = 2,
) -> torch.Tensor:
    """The full rectified sweep in plain torch (port of
    rectified_sweep_corr_jnp): the semantic reference for the resample and
    1-D sweep kernels, and the accuracy probe for the approximation.

    Args:
      src_feat, ref_feat: (N, H, W, C), one image per pair.
      rel: (N, 3|4, 4) relative fused projections.
      inv_lo, inv_step: (N, H, W) inverse-depth fan (per original ref pixel).

    Returns:
      (N, D, H, W, groups) correlation volumes on the original ref grid.
    """
    n, h, w, _ = src_feat.shape
    rect = compute_rectification(rel, h, w)

    # one 2-D resample per image (amortised over all D planes)
    src_r = warp.bilinear_sample(src_feat, *rect_grid_coords(rect.h_src, h, w))
    ref_r = warp.bilinear_sample(ref_feat, *rect_grid_coords(rect.h_ref, h, w))

    p0, p1 = sweep_coeff_maps(rect, inv_lo, inv_step, h, w)
    ds = torch.arange(ndepth, dtype=torch.float32, device=rel.device)[None, :, None, None]
    px = p0[:, None] + ds * p1[:, None]                       # (N, D, H, W)
    py = pixel_grid(h, w, rel.device)[1][:, None].expand_as(px)

    # per-plane 1-D (horizontal) lerp == bilinear at (px, y_hat)
    warped = warp.bilinear_sample(src_r, px, py)              # (N, D, H, W, C)
    corr_r = warp.group_correlation(warped, ref_r, groups)    # (N, D, H, W, G)

    # un-rectify once (depth-independent coords)
    vol = corr_r.permute(0, 2, 3, 1, 4).reshape(n, h, w, ndepth * groups)
    out = warp.bilinear_sample(vol, *unrect_grid_coords(rect.h_ref, h, w))
    return out.reshape(n, h, w, ndepth, groups).permute(0, 3, 1, 2, 4)
