"""Dual-depth regression head ("saddle-shaped depth cells"), functional
(port of dmvsnet_tpu.models.depth_net).

* ``forward``: softmax + soft-argmax per cost channel gives 4 depths per
  pixel (2 "small"-cell + 2 "huge"-cell); linear extrapolation stacks and
  a mod-4 x mod-2 checkerboard pick 4 new hypothesis planes per pixel for
  the refine pass.
* ``refine``: sharpened softmax (alpha=5), then a 2x2 checkerboard
  selects the final depth from {small_min, small_max, huge_max, huge_min}.

Layouts as in the JAX package: cost_reg (B, D, H, W, 4); depth_values
(B, D, H, W); depth maps (B, H, W); depth_values_c (B, 4, H, W).  fp32.
"""

from __future__ import annotations

import torch


def _parity(height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    return y, x


def soft_argmax_depth(prob: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """sum_D(prob * depth) per channel: (B, D, H, W, C) -> (B, H, W, C)."""
    return (prob * depth_values[..., None]).sum(dim=1)


def _confidence(depth4: torch.Tensor, interval: torch.Tensor) -> torch.Tensor:
    """2*(sigmoid(interval/std)-0.5), biased std over the 4 depths + 1e-5."""
    std = torch.sqrt(depth4.var(dim=-1, correction=0)) + 1e-5
    return (2.0 * (torch.sigmoid(interval / std) - 0.5)).detach()


def _stack6(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """{3mn-2mx, 2mn-mx, mn, mx, 2mx-mn, 3mx-2mn} along a new last axis."""
    return torch.stack(
        [3 * mn - 2 * mx, 2 * mn - mx, mn, mx, 2 * mx - mn, 3 * mx - 2 * mn], dim=-1
    )


def forward(
    cost_reg: torch.Tensor, depth_values: torch.Tensor, interval: torch.Tensor
) -> dict[str, torch.Tensor]:
    """First-pass head: prob_volume, depth_sub_plus (B, H, W, 4),
    depth_values_c (B, 4, H, W), photometric_confidence, depth_values,
    interval."""
    prob = torch.softmax(cost_reg.float(), dim=1)
    depth4 = soft_argmax_depth(prob, depth_values)

    small, huge = depth4[..., :2], depth4[..., 2:]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)
    # doubled-interval variants
    s_min_d, s_max_d = 2 * s_min - s_max, 2 * s_max - s_min
    h_min_d, h_max_d = 2 * h_min - h_max, 2 * h_max - h_min

    small_stack = _stack6(s_min, s_max)
    small_stack_d = _stack6(s_min_d, s_max_d)
    huge_stack = _stack6(h_min, h_max)
    huge_stack_d = _stack6(h_min_d, h_max_d)

    y, x = _parity(depth4.shape[1], depth4.shape[2], depth4.device)
    y4, x2 = (y % 4)[None, :, :, None], (x % 2)[None, :, :, None]

    # mod-4 row x mod-2 col checkerboard -> 4 new planes per pixel: rows
    # 0/1 use the plain stacks, rows 2/3 the doubled-interval stacks; even
    # cols slice [:4] for small / [2:] for huge, odd cols the mirror
    dv_c = torch.zeros_like(depth4)
    dv_c = torch.where((y4 == 0) & (x2 == 0), small_stack[..., :4], dv_c)
    dv_c = torch.where((y4 == 0) & (x2 == 1), small_stack[..., 2:], dv_c)
    dv_c = torch.where((y4 == 1) & (x2 == 0), huge_stack[..., 2:], dv_c)
    dv_c = torch.where((y4 == 1) & (x2 == 1), huge_stack[..., :4], dv_c)
    dv_c = torch.where((y4 == 2) & (x2 == 0), small_stack_d[..., :4], dv_c)
    dv_c = torch.where((y4 == 2) & (x2 == 1), small_stack_d[..., 2:], dv_c)
    dv_c = torch.where((y4 == 3) & (x2 == 0), huge_stack_d[..., 2:], dv_c)
    dv_c = torch.where((y4 == 3) & (x2 == 1), huge_stack_d[..., :4], dv_c)

    return {
        "prob_volume": prob,
        "depth_sub_plus": depth4,
        "depth_values_c": dv_c.permute(0, 3, 1, 2),
        "photometric_confidence": _confidence(depth4, interval),
        "depth_values": depth_values,
        "interval": interval,
    }


def refine(
    cost_reg: torch.Tensor, depth_values: torch.Tensor, interval: torch.Tensor,
    alpha: float = 5.0,
) -> dict[str, torch.Tensor]:
    """Refine-pass head; depth_values are the 4 checkerboard planes
    (B, 4, H, W)."""
    prob = torch.softmax(cost_reg.float() * alpha, dim=1)
    depth4 = soft_argmax_depth(prob, depth_values)

    small, huge = depth4[..., :2], depth4[..., 2:]
    s_min, s_max = small.amin(-1), small.amax(-1)
    h_min, h_max = huge.amin(-1), huge.amax(-1)

    y, x = _parity(depth4.shape[1], depth4.shape[2], depth4.device)
    y2, x2 = (y % 2)[None], (x % 2)[None]
    depth = torch.zeros_like(s_min)
    depth = torch.where((y2 == 0) & (x2 == 0), s_min, depth)
    depth = torch.where((y2 == 0) & (x2 == 1), s_max, depth)
    depth = torch.where((y2 == 1) & (x2 == 0), h_max, depth)
    depth = torch.where((y2 == 1) & (x2 == 1), h_min, depth)

    return {
        "depth": depth,
        "photometric_confidence_refine": _confidence(depth4, interval),
        "depth_sub_plus_refine": depth4,
    }
