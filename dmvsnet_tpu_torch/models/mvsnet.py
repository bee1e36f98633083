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
  carries no gradient on either path;
* ``warp_impl="epipolar"`` sends the (stage, pass) pairs listed in
  ``epipolar_main_stages`` / ``epipolar_refine_stages`` through the
  rectified 1-D sweep (ops.epipolar_sweep: the resample and sweep kernels,
  per-view fallback to the exact kernel) when the module is in eval mode.
  The sweep is an approximation without a gradient, so a module in training
  mode sends every pass to the exact kernel.  Each stage's output carries
  ``sweep_engaged`` and ``sweep_engaged_refine``: (B, V-1) bool tensors on
  the CPU saying which (batch element, source view) took the sweep.

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
from dmvsnet_tpu_torch.ops import epipolar_sweep, warp_correlate

# Per-(stage, pass) epipolar routing, consulted only under
# warp_impl="epipolar": the stage indices whose main / refine cost pass take
# the rectified 1-D sweep; the others keep the exact kernel.  The defaults
# (0, 1) / () are the JAX package's TPU routing, kept so that
# --warp_impl epipolar routes as the JAX package does.  They were not chosen
# on the card: on an H100 the whole epipolar pass lost to the exact pass at
# every (stage, pass) (chip_smoke.py's "ab" lines; PERF.md §6), which is why
# warp_impl="auto" never takes it.  Change them only from "ab" lines.
EPIPOLAR_MAIN_STAGES: tuple[int, ...] = (0, 1)
EPIPOLAR_REFINE_STAGES: tuple[int, ...] = ()


class MVSNet(nn.Module):
    def __init__(
        self,
        ndepths: Sequence[int] = (48, 32, 8),
        depth_interval_ratio: Sequence[float] = (4.0, 2.0, 1.0),
        cr_base_channels: Sequence[int] = (8, 8, 8),
        base_channels: int = 8,
        inverse_depth: bool = False,
        warp_impl: str = "cuda",
        epipolar_main_stages: Sequence[int] | None = None,
        epipolar_refine_stages: Sequence[int] | None = None,
    ):
        super().__init__()
        if warp_impl not in ("cuda", "epipolar", "torch"):
            raise ValueError(
                f"warp_impl must be 'cuda', 'epipolar' or 'torch', got {warp_impl!r}")
        self.epipolar_main_stages = tuple(
            EPIPOLAR_MAIN_STAGES if epipolar_main_stages is None else epipolar_main_stages)
        self.epipolar_refine_stages = tuple(
            EPIPOLAR_REFINE_STAGES if epipolar_refine_stages is None else epipolar_refine_stages)
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

            def cost_pass(key: str, dv: torch.Tensor, reg: nn.Module, sweep_stages):
                engaged = None
                if self.warp_impl == "epipolar" and not self.training and s in sweep_stages:
                    cost, engaged = epipolar_sweep.aggregate_cost_volume_epipolar(
                        feats[key], proj2, dv)
                else:
                    cost = warp_correlate.aggregate_cost_volume(
                        feats[key], proj2, dv,
                        impl="torch" if self.warp_impl == "torch" else "cuda")
                    if self.warp_impl == "epipolar":
                        engaged = torch.zeros((b, v - 1), dtype=torch.bool)
                out = reg(cost.permute(0, 4, 1, 2, 3).contiguous())  # (B, 4, D, h, w)
                return out.permute(0, 2, 3, 4, 1), engaged           # (B, D, h, w, 4)

            # pass 1: full-plane sweep
            cost_reg, engaged = cost_pass(stage, samples, self.cost_regularization[s],
                                          self.epipolar_main_stages)
            stage_out = depth_net.forward(cost_reg, samples, interval)

            # pass 2: 4-plane checkerboard refine on the "_c" features
            dv_c = stage_out["depth_values_c"]
            cost_reg_c, engaged_c = cost_pass(stage + "_c", dv_c,
                                              self.cost_regularization_refine[s],
                                              self.epipolar_refine_stages)
            refine_out = depth_net.refine(cost_reg_c, dv_c, interval)
            if engaged is not None:
                refine_out["sweep_engaged"] = engaged
                refine_out["sweep_engaged_refine"] = engaged_c

            # first-pass keys win: the final photometric_confidence is the
            # stage-3 first-pass confidence, as in the reference
            stage_out = {**refine_out, **stage_out}
            last_depth = stage_out["depth"]
            outputs[stage] = stage_out
            outputs.update(stage_out)
        return outputs
