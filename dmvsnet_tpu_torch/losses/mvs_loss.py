"""Dual-depth training loss (port of dmvsnet_tpu.losses.mvs_loss).

Per stage and per pass (forward + refine), four term groups:

  (a) 2x smooth-L1 on the small pair + 2x on the huge pair vs GT;
  (b) "variance" losses pulling |d0-d1| (small) and |d2-d3| (huge)
      toward the larger of the two GT errors;
  (c) 4 Monte-Carlo sub-pixel losses on checkerboard min/max composites,
      sampled at half-pixel centers;
  (d) the same block on the refine outputs.

As in the JAX package, empty-mask reductions return 0, not NaN.  All
losses are computed in float32.  Layouts: depth maps (B, H, W), depth4
(B, H, W, 4).

Under data parallelism (a ``mesh`` with a dp axis) every masked mean is one
of the global batch, as in the JAX package under jit over a dp-sharded
batch: the local masked sum over the mask count summed over the dp group.
The per-rank value is scaled by the dp size, so that DDP's mean of the
ranks' gradients is the gradient of the global loss and the dp mean of the
per-rank values is the global loss.
"""

from __future__ import annotations

import torch

from dmvsnet_tpu_torch.core.sampling import checkerboard
from dmvsnet_tpu_torch.parallel.mesh import AXIS_DATA


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (huber, beta=1)."""
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_ratio(total: torch.Tensor, count: torch.Tensor, mesh=None) -> torch.Tensor:
    """``total / count``, 0 where ``count`` is 0.  With a ``mesh`` whose dp
    axis has n > 1 ranks: ``count`` is summed over the dp group (no gradient)
    and the ratio is multiplied by n (module docstring)."""
    n = 1 if mesh is None else mesh.size(AXIS_DATA)
    if n > 1:
        count = mesh.all_reduce(count, AXIS_DATA)
        total = total * n
    return torch.where(count > 0, total / count.clamp(min=1), torch.zeros_like(total))


def masked_weighted_mean(values: torch.Tensor, mask: torch.Tensor, mesh=None) -> torch.Tensor:
    return masked_ratio((values * mask).sum(), mask.sum(), mesh)


def regression_loss(depth_est, depth_gt, mask, weight, mesh=None) -> torch.Tensor:
    """(smooth_l1(est, gt) * weight) averaged over masked elements."""
    return masked_weighted_mean(smooth_l1(depth_est, depth_gt) * weight, mask, mesh)


def half_pixel_pool(x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (B, H, W) map at all (i+0.5, j+0.5) centers:
    the mean of each 2x2 block, (B, H-1, W-1)."""
    return 0.25 * (x[:, :-1, :-1] + x[:, :-1, 1:] + x[:, 1:, :-1] + x[:, 1:, 1:])


def subpixel_pool(x: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (B, H, W) map at (i+oy, j+ox), offsets in [0,1)."""
    w00 = (1.0 - oy) * (1.0 - ox)
    w01 = (1.0 - oy) * ox
    w10 = oy * (1.0 - ox)
    w11 = oy * ox
    return (w00 * x[:, :-1, :-1] + w01 * x[:, :-1, 1:]
            + w10 * x[:, 1:, :-1] + w11 * x[:, 1:, 1:])


def monte_carlo_offsets(shape, generator: torch.Generator, device=None):
    """Per-cell offsets (ox, oy) ~ U[0,1) of mode="random", drawn from an
    explicit generator (on its device, then moved to ``device``):
    (B, H-1, W-1) each for a (B, H, W) map."""
    cells = (shape[0], shape[1] - 1, shape[2] - 1)
    ox, oy = (torch.rand(cells, generator=generator, device=generator.device).to(device)
              for _ in range(2))
    return ox, oy


def monte_carlo_loss(
    depth_est: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
    weight: torch.Tensor, mode: str = "center", reflect: bool = False,
    generator: torch.Generator | None = None,
    offsets: tuple[torch.Tensor, torch.Tensor] | None = None,
    mesh=None,
) -> torch.Tensor:
    """Sub-pixel composite loss.

    mode="center" samples GT/est/weight/mask at half-pixel centers (the
    only mode shipped configs use); mode="random" draws per-cell offsets
    U[0,1) from ``generator`` (or takes them as ``offsets=(ox, oy)``).
    Keeps only cells whose sampled mask reaches 1 (all four neighbours
    valid).  reflect=True: cells whose 2x2 sign pattern of (est - gt) is
    uniform get weight 2 (no gradient through the weights), and the loss
    is the plain masked smooth-L1 of the reweighted samples.
    """
    if mode == "center":
        pool = half_pixel_pool
    elif mode == "random":
        if offsets is None:
            if generator is None:
                raise ValueError('monte_carlo_loss(mode="random") needs a '
                                 "torch.Generator or explicit offsets")
            offsets = monte_carlo_offsets(depth_gt.shape, generator, depth_gt.device)
        ox, oy = offsets
        pool = lambda x: subpixel_pool(x, ox, oy)  # noqa: E731
    else:
        raise ValueError(f"unknown Monte-Carlo sampling mode {mode!r}")
    s_gt = pool(depth_gt)
    s_est = pool(depth_est)
    # center-mode pooling of a 0/1 mask is exact; random offsets round, so
    # test against 1 with an fp margin
    thresh = 1.0 if mode == "center" else 1.0 - 1e-5
    s_mask = (pool(mask.float()) >= thresh).float()
    if reflect:
        err = (depth_est - depth_gt).detach()
        up = half_pixel_pool((err > 0).float()) == 1.0
        dn = half_pixel_pool((err < 0).float()) == 1.0
        rw = torch.where(up | dn, 2.0, 1.0)
        return masked_weighted_mean(smooth_l1(rw * s_est, rw * s_gt), s_mask, mesh)
    s_w = pool(weight)
    return regression_loss(s_est, s_gt, s_mask, s_w, mesh)


def _pass_loss(depth4, depth_gt, mask, stage_weight, mesh=None) -> torch.Tensor:
    """The 8-term block shared by forward and refine passes.

    depth4: (B, H, W, 4) = [small0, small1, huge0, huge1];
    depth_gt, mask: (B, H, W).
    """
    w_map = torch.full_like(depth_gt, stage_weight)
    gt4 = depth_gt[..., None]
    mask4 = mask[..., None]

    small, huge = depth4[..., :2], depth4[..., 2:]
    loss_depth = 2.0 * regression_loss(
        small, gt4.expand_as(small), mask4.expand_as(small), stage_weight, mesh,
    ) + 2.0 * regression_loss(
        huge, gt4.expand_as(huge), mask4.expand_as(huge), stage_weight, mesh,
    )

    def var_loss(a, b):
        var_gt = torch.maximum((a - depth_gt).abs(), (b - depth_gt).abs())
        return regression_loss((a - b).abs(), var_gt, mask, w_map, mesh)

    loss_var = var_loss(depth4[..., 0], depth4[..., 1]) + var_loss(
        depth4[..., 2], depth4[..., 3])

    cb = checkerboard(*depth_gt.shape[-2:], device=depth_gt.device)[None]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)
    loss_mc = (
        monte_carlo_loss(torch.where(cb, s_min, s_max), depth_gt, mask, w_map, mesh=mesh)
        + monte_carlo_loss(torch.where(~cb, s_min, s_max), depth_gt, mask, w_map, mesh=mesh)
        + monte_carlo_loss(torch.where(cb, h_min, h_max), depth_gt, mask, w_map, mesh=mesh)
        + monte_carlo_loss(torch.where(~cb, h_min, h_max), depth_gt, mask, w_map, mesh=mesh)
    )
    return loss_depth + loss_var + loss_mc


def mvs_loss(
    outputs: dict, depth_gt_ms: dict, mask_ms: dict, mode: str = "regression",
    dlossw: tuple = (0.5, 1.0, 2.0), mesh=None,
) -> torch.Tensor:
    """Total loss over stages.

    Args:
      outputs: model output dict (per-stage dicts under "stage{i}").
      depth_gt_ms / mask_ms: {"stage{i}": (B, H_i, W_i)} pyramids.
      mode: "regression" (dual-depth path) | "classification" | "gfocal"
        | "unification" (alternates live in ``losses.alt_losses``).
      mesh: a ``parallel.Mesh``: the loss of the global batch (module
        docstring); None, this process's batch.
    """
    if mode != "regression":
        from dmvsnet_tpu_torch.losses import alt_losses

        return alt_losses.alt_mvs_loss(outputs, depth_gt_ms, mask_ms, mode, dlossw, mesh)

    total = 0.0
    for key in [k for k in outputs if k.startswith("stage")]:
        stage = outputs[key]
        sw = float(dlossw[int(key.replace("stage", "")) - 1])
        gt = depth_gt_ms[key].float()
        mask = (mask_ms[key] > 0.5).float()
        total = total + _pass_loss(stage["depth_sub_plus"], gt, mask, sw, mesh)
        total = total + _pass_loss(stage["depth_sub_plus_refine"], gt, mask, sw, mesh)
    return total
