"""The cascade dual-depth MVS network (port of dmvsnet_tpu.models.mvsnet).
``model.train()`` / ``model.eval()`` select the batch-norm mode, as the JAX
package's ``train`` argument does.

* all B*V images go through the feature net in one call: in training the
  batch statistics stay view- and batch-global, and eval batch norm uses
  running statistics, so one call equals any chunking;
* 3 cascade stages at 1/4, 1/2, 1/1 resolution; each stage runs two cost
  passes: a D-plane sweep (CostRegNet) and a 4-plane checkerboard refine
  (CostRegNetRefine) on the "_c" feature half;
* every cost pass is one call of ops.warp_correlate: the hand-written CUDA
  kernel (``warp_impl="cuda"``; its backward is the two adjoint kernels)
  or its plain PyTorch version (``warp_impl="torch"``).  The sampling grid
  carries no gradient on either path.

Public layouts are the JAX package's: imgs (B, V, H, W, 3) with view 0 the
reference; proj_matrices {"stage1".."stage3": (B, V, 2, 4, 4)};
depth_values (B, D0).  Outputs: the flat dict with "depth",
"photometric_confidence", ... plus per-stage dicts under "stage{i}".
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from dmvsnet_tpu_torch.core import sampling
from dmvsnet_tpu_torch.models import depth_net
from dmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetRefine
from dmvsnet_tpu_torch.models.feature_net import FeatureNet
from dmvsnet_tpu_torch.ops import warp_correlate


class MVSNet(nn.Module):
    def __init__(
        self,
        ndepths: Sequence[int] = (48, 32, 8),
        depth_interval_ratio: Sequence[float] = (4.0, 2.0, 1.0),
        cr_base_channels: Sequence[int] = (8, 8, 8),
        base_channels: int = 8,
        inverse_depth: bool = False,
        warp_impl: str = "cuda",
    ):
        super().__init__()
        if warp_impl not in ("cuda", "torch"):
            raise ValueError(f"warp_impl must be 'cuda' or 'torch', got {warp_impl!r}")
        self.ndepths = tuple(ndepths)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.inverse_depth = inverse_depth
        self.warp_impl = warp_impl
        self.feature = FeatureNet(base_channels)
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(c) for c in cr_base_channels])
        self.cost_regularization_refine = nn.ModuleList(
            [CostRegNetRefine(c) for c in cr_base_channels])

    def forward(
        self,
        imgs: torch.Tensor,
        proj_matrices: dict[str, torch.Tensor],
        depth_values: torch.Tensor,
    ) -> dict[str, Any]:
        num_stage = len(self.ndepths)
        b, v, h, w, _ = imgs.shape
        scale0 = 2 ** (num_stage - 1)
        if h % (scale0 * 8) or w % (scale0 * 8):
            raise ValueError(
                f"image size ({h}x{w}) must be divisible by {scale0 * 8}: the "
                "coarsest stage runs at 1/4 resolution through a 3-level "
                "stride-2 cost U-Net"
            )
        for nd in self.ndepths:
            if nd % 8:
                raise ValueError(
                    f"each ndepths entry must be divisible by 8 (got {self.ndepths}): "
                    "the cost U-Net halves the plane axis three times"
                )
        depth_values = depth_values.float()
        # NOTE: divided by D0, not D0-1 (as the reference does)
        depth_interval = (depth_values[0, -1] - depth_values[0, 0]) / depth_values.shape[1]

        x = imgs.float().reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2)
        feats = self.feature(x.contiguous())
        # channels-last (B, V, h, w, C): each bilinear tap of the cost pass
        # reads C contiguous floats
        feats = {k: f.reshape(b, v, *f.shape[1:]).permute(0, 1, 3, 4, 2).contiguous()
                 for k, f in feats.items()}

        outputs: dict[str, Any] = {}
        last_depth = None
        for s in range(num_stage):
            stage = f"stage{s + 1}"
            scale = 2 ** (num_stage - s - 1)
            sh, sw = h // scale, w // scale
            proj2 = proj_matrices[stage]

            if s == 0:
                samples, interval = sampling.stage1_samples(
                    depth_values, self.ndepths[0], sh, sw, inverse=self.inverse_depth)
            else:
                samples, interval = sampling.cascade_samples(
                    last_depth.detach(), self.ndepths[s],
                    self.depth_interval_ratio[s] * depth_interval,
                    inverse=self.inverse_depth)
                samples = sampling.upsample_depth_samples(samples, sh, sw)

            def cost_pass(key: str, dv: torch.Tensor, reg: nn.Module) -> torch.Tensor:
                cost = warp_correlate.aggregate_cost_volume(
                    feats[key], proj2, dv, impl=self.warp_impl)  # (B, D, h, w, 2)
                out = reg(cost.permute(0, 4, 1, 2, 3).contiguous())  # (B, 4, D, h, w)
                return out.permute(0, 2, 3, 4, 1)                    # (B, D, h, w, 4)

            # pass 1: full-plane sweep
            cost_reg = cost_pass(stage, samples, self.cost_regularization[s])
            stage_out = depth_net.forward(cost_reg, samples, interval)

            # pass 2: 4-plane checkerboard refine on the "_c" features
            dv_c = stage_out["depth_values_c"]
            cost_reg_c = cost_pass(stage + "_c", dv_c, self.cost_regularization_refine[s])
            refine_out = depth_net.refine(cost_reg_c, dv_c, interval)

            # first-pass keys win: the final photometric_confidence is the
            # stage-3 first-pass confidence, as in the reference
            stage_out = {**refine_out, **stage_out}
            last_depth = stage_out["depth"]
            outputs[stage] = stage_out
            outputs.update(stage_out)
        return outputs
