"""The plain PyTorch reference of DMVSNet with adaptive view aggregation
(``agg_mode="adaptive"``), which decides ``correct`` for the configuration
``dmvsnet_tank_adaptive``.

``reference/model.py``'s cascade with its cost volume replaced: per source
view v, the cost pass on the (reference, source v) pair alone, that pair's
two-group correlation gated by a learned per-voxel weight,
``sigmoid(net(corr))``, and the gated pairs summed in view order.  The net
is one per stage and pass (``agg_weight[s]`` for the main pass of stage s,
``agg_weight_refine[s]`` for its refine pass), called once per source view:
a 1x1x1 3-D convolution 2 -> 1 with batch norm and ReLU (``w0``), then one
1 -> 1 with batch norm and ReLU (``w1``).  The names are the program's, so
the benchmark's seeded weights fill both models alike.

The pair passes go through ``model.cost_pass``, looked up in
``mvsbench.reference.model`` at each call, so that ``mvsbench/counts``
counts each pair as a pass of its own at V = 2, as kernel 1 runs it.  It
runs in float32; the modes switch TF32 off before they build it.  It
imports nothing of the program and nothing of JAX.

Departures from upstream DMVSNet (github.com/DIVE128/DMVSNet), whose
``main.py --agg_mode adaptive`` builds ``AggWeightNetVolume``
(``networks/mvsnet.py:107-108``, the net at ``networks/module.py:437-451``):

* upstream's cost aggregation (``networks/mvsnet.py:102-153``) has no
  adaptive branch: it builds the net and never calls it, and its released
  scripts all run ``variance`` (SURVEY.md §2.2, §2.9).  The gating here,
  ``corr * sigmoid(net(corr))`` per source view before the sum, with one
  net per stage and pass, is the realisation of the JAX package that this
  repository ports (``dmvsnet_tpu/ops/warp.py``,
  ``aggregate_cost_volume_adaptive``), and the program's, not upstream
  code;
* the net's layers are the JAX package's ``AggWeightNetVolume``: ``w0``
  takes the 2 channels of the two-group correlation, and each block is a
  convolution without bias, batch norm and ReLU.  Upstream's
  ``module.py`` is not in this repository, so that its blocks match these
  layer for layer is not checked here;
* upstream's checkpoints carry no weights for the net (the port's
  ``convert.py`` gives them names of its own); the benchmark's are seeded.
"""

from __future__ import annotations

import torch
from torch import nn

from mvsbench.reference import model


class AggWeightNet(nn.Module):
    """Per-voxel gate logits: (B, 2, D, H, W) -> (B, 1, D, H, W)."""

    def __init__(self):
        super().__init__()
        self.w0 = model.Block(2, 1, 1, dims=3)
        self.w1 = model.Block(1, 1, 1, dims=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w1(self.w0(x))


class AdaptiveMVSNet(model.MVSNet):
    def __init__(self, *args):
        super().__init__(*args)
        n = len(self.cost_regularization)
        self.agg_weight = nn.ModuleList([AggWeightNet() for _ in range(n)])
        self.agg_weight_refine = nn.ModuleList([AggWeightNet() for _ in range(n)])

    def cost_volume(self, stage: int, refine: bool, feats, rel, depth) -> torch.Tensor:
        net = (self.agg_weight_refine if refine else self.agg_weight)[stage]
        total = None
        for i in range(1, feats.shape[1]):
            corr = model.cost_pass(feats[:, [0, i]], rel[:, i - 1:i].contiguous(), depth)
            logits = net(corr.permute(0, 4, 1, 2, 3).contiguous()).permute(0, 2, 3, 4, 1)
            corr = corr * torch.sigmoid(logits)
            total = corr if total is None else total + corr
        return total


def build(config: dict, device) -> AdaptiveMVSNet:
    return model.build(config, device, AdaptiveMVSNet)
