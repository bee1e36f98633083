"""Camera / plane-sweep geometry in fp32 (port of dmvsnet_tpu.core.geometry).

Conventions as in the JAX package: ``proj2`` is the (..., 2, 4, 4)
stacked camera [extrinsics; intrinsics in the top-left 3x3], ``fused`` the
(..., 4, 4) matrix [[K R | K t], [0 | 1]], pixel coordinates are (x, y)
with x along width.

Every contraction here is written out as elementwise multiply-and-sum, so
it stays exact fp32 whatever the TF32 flags of cuBLAS are: a
reduced-precision product shifts every warp coordinate (the JAX package
measured a 0.25-row shift from bf16 matmul passes).  3x3 inverses use the
closed-form adjugate.
"""

from __future__ import annotations

import torch


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b as an fp32 multiply-and-sum (no BLAS, no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det), batched over leading dims."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def fuse_projection(proj2: torch.Tensor) -> torch.Tensor:
    """(..., 2, 4, 4) -> (..., 4, 4): rows :3 become K[:3,:3] @ E[:3,:4]."""
    ext = proj2[..., 0, :, :]
    intr = proj2[..., 1, :3, :3]
    top = _matmul(intr, ext[..., :3, :4])
    return torch.cat([top, ext[..., 3:4, :]], dim=-2)


def invert_fused(fused: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [[A, b], [0, 1]]: [[A^-1, -A^-1 b], [0, 1]]."""
    a = fused[..., :3, :3]
    b = fused[..., :3, 3:4]
    a_inv = inv3(a)
    top = torch.cat([a_inv, -_matmul(a_inv, b)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=fused.dtype,
                          device=fused.device).expand(*fused.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def relative_projection(src_fused: torch.Tensor, ref_fused: torch.Tensor) -> torch.Tensor:
    """src @ inv(ref): maps ref-camera homogeneous coords to src pixels."""
    return _matmul(src_fused, invert_fused(ref_fused))


def relative_projections(proj2: torch.Tensor) -> torch.Tensor:
    """(B, V, 2, 4, 4) cameras -> (B, V-1, 3, 4) rows of src_v @ inv(ref)
    for the source views v = 1..V-1 (view 0 is the reference)."""
    fused = fuse_projection(proj2.float())
    rel = relative_projection(fused[:, 1:], fused[:, :1])
    return rel[..., :3, :].contiguous()


def plane_sweep_coords(
    rel_proj: torch.Tensor, depth_values: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coordinates of every (ref pixel, depth plane).

    p = R' (x, y, 1)^T * d + t' with R' = rel[:3,:3], t' = rel[:3,3];
    (px, py) = (p0/p2, p1/p2), with z == 0 replaced by 1e-5.

    Args:
      rel_proj: (B, 4, 4) or (B, 3, 4) relative fused projection.
      depth_values: (B, D) per-image planes or (B, D, H, W) per-pixel.

    Returns:
      (px, py), each (B, D, H, W).
    """
    b = rel_proj.shape[0]
    d = depth_values.shape[1]
    rot = rel_proj[:, :3, :3]
    trans = rel_proj[:, :3, 3]
    dev = rel_proj.device
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    # (B, 3, H, W): R' (x, y, 1)^T
    rot_xyz = (rot[:, :, 0, None, None] * x + rot[:, :, 1, None, None] * y
               + rot[:, :, 2, None, None])
    depth = (depth_values.reshape(b, d, 1, 1) if depth_values.dim() == 2
             else depth_values).expand(b, d, height, width)
    # (B, 3, D, H, W)
    p = rot_xyz[:, :, None] * depth[:, None] + trans[:, :, None, None, None]
    z = p[:, 2]
    z = torch.where(z == 0.0, z + 1e-5, z)
    return p[:, 0] / z, p[:, 1] / z
