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
  the CPU saying which (batch element, source view) took the sweep;
* ``mesh`` (a ``parallel.Mesh``): train-mode batch norm takes its statistics
  over the dp group (``blocks.sync_batch_norm``), and where the vp axis has
  more than one rank and divides V-1 every cost pass sums the source views
  over it (``warp_correlate.aggregate_cost_volume_view_sharded``), ahead of
  the epipolar routing, which vp then never takes, as in the JAX package.
  Without a mesh, or with vp = 1, the forward is the one-process forward;
* where the mesh's sp axis has more than one rank, every cost pass is
  computed on the whole image (as the JAX package's Pallas warp is, which
  GSPMD does not partition), then each sp rank takes its band of rows
  (``parallel.spatial.row_bands``), runs the cost U-Net on it with halo
  exchanges (``blocks.spatial_split``; batch norm over the ("dp", "sp")
  group) and the depth head on it (bands start on multiples of 8 rows, so
  the heads' row parities are the global ones), and gathers every head
  output back to the whole image (``parallel.spatial.gather_rows``); from
  there on each sp rank holds the whole maps, as without sp.  A stage whose
  height does not divide over sp runs unsplit, as the JAX package's
  ``constrain`` leaves it.  Gradients: ``gather_rows`` is a psum, so every
  band receives sp times its cotangent (every sp rank computes the same
  loss on the same whole maps; losses/ reduce over dp only), and DDP's
  mean over the dp x sp ranks turns that into the one-process gradient:
  a U-Net parameter gets the mean over sp of sp * g_band, the sum over the
  bands, g; the feature net and the weight nets get the same through the
  band slice of the cost volume, whose backward hands kernels 2-3 a
  cotangent that is zero outside the band.  This is the vp argument of
  ``ops/warp_correlate.aggregate_cost_volume_view_sharded`` with rows for
  source views;
* ``agg_mode="adaptive"`` gates each source view's correlation by a learned
  per-voxel weight before the view sum (``models/cost_reg.AggWeightNetVolume``,
  one net per stage and pass).  Where the net's two blocks fold their eval
  norms (eval, fp32, autograd off, no cost count:
  ``AggWeightNetVolume.gate_params``) and the features have C in
  ``warp_correlate.CHANNELS``, a pass is one gated pass that warps,
  correlates, gates and sums every source view
  (``warp_correlate.aggregate_cost_volume_gated``, one kernel launch);
  otherwise (training, eval with grad, the bf16 policies, the count) it
  runs pair by pair, kernel 1 on each (reference, source) pair and the net
  called once per source view (``warp_correlate.aggregate_cost_volume_adaptive``).
  ``warp_correlate.adaptive_stats()`` counts the passes of each route.
  It takes precedence over the vp sum and the epipolar routing, as in the
  JAX package;
* dtypes as in the JAX package: ``dtype`` (compute) is what the features
  are cast to after the feature net; ``feature_dtype`` / ``costreg_dtype``
  (None: ``dtype``) are the compute dtypes of the feature net and of the
  cost U-Nets, whose inputs are cast to it.  The cost passes are fp32
  (their entries upcast bf16 features), the depth heads fp32, parameters
  and batch-norm statistics fp32;
* ``remat=True`` in train mode recomputes in the backward the feature net,
  each cost U-Net and each cost pass but the adaptive one
  (``blocks.checkpoint``; running statistics are updated once per step),
  as the JAX package's ``nn.remat`` / ``jax.checkpoint`` do;
* ``fold_level0`` (None, True or False; an attribute, so one model switches
  plans): True runs the feature net's full-resolution level in folded form,
  and the level 0 of every cost U-Net whose input meets
  ``models/folded.use_folded_level0`` (at DTU eval the stage-3 main pass and
  the three refine passes), as the JAX package's ``fold_level0=True`` does;
  False folds nothing.  None is the port's default for the card, which in
  this package is unfolded everywhere: the JAX package's None (cost U-Nets
  folded, feature net not) was chosen on a TPU.  Parameters, names and
  shapes are the same under every plan.  Where the plan is decided:
  ``models/folded.level0`` per call of the feature net and of each U-Net
  branch; the blocks of both plans run through ``models/blocks._Block``,
  whose norm (``blocks._BiasedRunningVar``) holds all batch-norm
  arithmetic; ``blocks.takes_fold`` is the count's rule: under
  ``engine/profiler``'s count every call runs the unfolded program, so the
  count is the same under every plan;
* ``run_stages`` (a diagnostic, as in the JAX package): 0 runs every
  stage; k stops after k whole stages; a fraction stops part way through
  stage int(k) + 1 and returns what it reached under ``outputs["partial"]``:
  + 0.2 the hypotheses (B, D, H, W), + 0.4 the first cost volume
  (B, D, H, W, 2), + 0.6 the cost U-Net's output (B, D, H, W, 4), + 0.8
  the refine cost volume, + 0.9 the refine U-Net's output.  The stage
  scales stay those of the full ``ndepths``.  Not with a mesh that splits
  rows (its U-Net outputs are bands).

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
from dmvsnet_tpu_torch.models import depth_net, folded
from dmvsnet_tpu_torch.models.blocks import checkpoint, spatial_split, sync_batch_norm
from dmvsnet_tpu_torch.models.cost_reg import AggWeightNetVolume, CostRegNet, CostRegNetRefine
from dmvsnet_tpu_torch.models.feature_net import FeatureNet
from dmvsnet_tpu_torch.ops import epipolar_sweep, warp_correlate
from dmvsnet_tpu_torch.parallel import spatial
from dmvsnet_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SPATIAL, AXIS_VIEW
from dmvsnet_tpu_torch.utils.trace import span

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

# the H axis of each head output that an sp rank gathers from the bands
_HEAD_H_AXIS = {"prob_volume": 2, "depth_sub_plus": 1, "depth_values_c": 2,
                "photometric_confidence": 1, "depth": 1, "photometric_confidence_refine": 1,
                "depth_sub_plus_refine": 1}


def check_shapes(h: int, w: int, ndepths: Sequence[int]) -> None:
    """Refuses an image size or a plane count that the cascade's 3-level
    stride-2 cost U-Nets cannot take."""
    scale0 = 2 ** (len(ndepths) - 1)
    if h % (scale0 * 8) or w % (scale0 * 8):
        raise ValueError(
            f"image size ({h}x{w}) must be divisible by {scale0 * 8}: the "
            "coarsest stage runs at 1/4 resolution through a 3-level "
            "stride-2 cost U-Net"
        )
    for nd in ndepths:
        if nd % 8:
            raise ValueError(
                f"each ndepths entry must be divisible by 8 (got {tuple(ndepths)}): "
                "the cost U-Net halves the plane axis three times"
            )


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
        mesh=None,
        agg_mode: str = "variance",
        dtype: torch.dtype = torch.float32,
        feature_dtype: torch.dtype | None = None,
        costreg_dtype: torch.dtype | None = None,
        remat: bool = False,
        run_stages: float = 0,
        fold_level0: bool | None = None,
    ):
        super().__init__()
        if warp_impl not in ("cuda", "epipolar", "torch"):
            raise ValueError(
                f"warp_impl must be 'cuda', 'epipolar' or 'torch', got {warp_impl!r}")
        if agg_mode not in ("variance", "adaptive"):
            raise ValueError(f"agg_mode must be 'variance' or 'adaptive', got {agg_mode!r}")
        self.epipolar_main_stages = tuple(
            EPIPOLAR_MAIN_STAGES if epipolar_main_stages is None else epipolar_main_stages)
        self.epipolar_refine_stages = tuple(
            EPIPOLAR_REFINE_STAGES if epipolar_refine_stages is None else epipolar_refine_stages)
        self.ndepths = tuple(ndepths)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.inverse_depth = inverse_depth
        self.warp_impl = warp_impl
        self.agg_mode = agg_mode
        self.remat = remat
        self.compute_dtype = dtype
        feature_dtype = dtype if feature_dtype is None else feature_dtype
        self.costreg_dtype = dtype if costreg_dtype is None else costreg_dtype
        self.feature = FeatureNet(base_channels, feature_dtype)
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(c, self.costreg_dtype) for c in cr_base_channels])
        self.cost_regularization_refine = nn.ModuleList(
            [CostRegNetRefine(c, self.costreg_dtype) for c in cr_base_channels])
        if agg_mode == "adaptive":
            self.agg_weight = nn.ModuleList(
                [AggWeightNetVolume(dtype=dtype) for _ in cr_base_channels])
            self.agg_weight_refine = nn.ModuleList(
                [AggWeightNetVolume(dtype=dtype) for _ in cr_base_channels])
        self.mesh = mesh
        self.run_stages = run_stages
        self.fold_level0 = fold_level0
        if mesh is not None:
            sync_batch_norm(self, mesh.group(AXIS_DATA))
            if mesh.size(AXIS_SPATIAL) > 1:
                if run_stages:
                    raise ValueError("run_stages does not run with a mesh that splits rows")
                for reg in (*self.cost_regularization, *self.cost_regularization_refine):
                    spatial_split(reg, mesh)

    @property
    def fold_level0(self) -> bool | None:
        return self._fold_level0

    @fold_level0.setter
    def fold_level0(self, value: bool | None) -> None:
        if value not in (None, True, False):
            raise ValueError(f"fold_level0 must be None, True or False, got {value!r}")
        self._fold_level0 = value
        for net in (self.feature, *self.cost_regularization, *self.cost_regularization_refine):
            folded.set_fold_level0(net, bool(value))

    def forward(
        self,
        imgs: torch.Tensor,
        proj_matrices: dict[str, torch.Tensor],
        depth_values: torch.Tensor,
    ) -> dict[str, Any]:
        with span("mvsnet.forward"):
            return self._forward(imgs, proj_matrices, depth_values)

    def _forward(self, imgs, proj_matrices, depth_values) -> dict[str, Any]:
        num_stage = len(self.ndepths)
        b, v, h, w, _ = imgs.shape
        check_shapes(h, w, self.ndepths)
        depth_values = depth_values.float()
        # NOTE: divided by D0, not D0-1 (as the reference does)
        depth_interval = (depth_values[0, -1] - depth_values[0, 0]) / depth_values.shape[1]

        x = imgs.float().reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2)
        feats = self._remat("mvsnet.feature", self.feature, x.contiguous())
        # channels-last (B, V, h, w, C) in the compute dtype: each bilinear
        # tap of the cost pass reads C contiguous values
        feats = {k: f.reshape(b, v, *f.shape[1:]).permute(0, 1, 3, 4, 2).to(
                     self.compute_dtype, memory_format=torch.contiguous_format)
                 for k, f in feats.items()}

        outputs: dict[str, Any] = {}
        last_depth = None
        vp = 1 if self.mesh is None else self.mesh.size(AXIS_VIEW)
        impl = "torch" if self.warp_impl == "torch" else "cuda"
        for s in range(num_stage):
            stage, name = f"stage{s + 1}", f"mvsnet.s{s + 1}"
            scale = 2 ** (num_stage - s - 1)
            sh, sw = h // scale, w // scale
            proj2 = proj_matrices[stage]

            with span(name + ".sample"):
                if s == 0:
                    samples, interval = sampling.stage1_samples(
                        depth_values, self.ndepths[0], sh, sw, inverse=self.inverse_depth)
                else:
                    samples, interval = sampling.cascade_samples(
                        last_depth.detach(), self.ndepths[s],
                        self.depth_interval_ratio[s] * depth_interval,
                        inverse=self.inverse_depth)
                    samples = sampling.upsample_depth_samples(samples, sh, sw)
            # this sp rank's rows of the stage, or None: the whole image
            bands = spatial.bands_for(sh, self.mesh, passes=2)
            band = None if bands is None else bands[self.mesh.coords[AXIS_SPATIAL]]

            def cost_volume(key: str, p: str, dv: torch.Tensor, sweep_stages,
                            weight_net: nn.Module | None):
                """(the (B, D, H, W, 2) fp32 cost volume, ``engaged`` or None)."""
                engaged, cost_span = None, f"{name}.{p}.cost"
                if self.agg_mode == "adaptive":
                    with span(cost_span):
                        gate = (weight_net.gate_params()
                                if feats[key].shape[-1] in warp_correlate.CHANNELS else None)
                        if gate is not None:
                            with span(f"{name}.{p}.gate"):
                                cost = warp_correlate.aggregate_cost_volume_gated(
                                    feats[key], proj2, dv, gate, impl)
                        else:
                            cost = warp_correlate.aggregate_cost_volume_adaptive(
                                feats[key], proj2, dv,
                                lambda sim: self._gate(f"{name}.{p}.gate", weight_net, sim),
                                impl)
                elif vp > 1 and (v - 1) % vp == 0:
                    cost = self._remat(cost_span, warp_correlate.aggregate_cost_volume_view_sharded,
                                       feats[key], proj2, dv, self.mesh, impl)
                elif self.warp_impl == "epipolar" and not self.training and s in sweep_stages:
                    with span(cost_span):
                        cost, engaged = epipolar_sweep.aggregate_cost_volume_epipolar(
                            feats[key], proj2, dv)
                else:
                    cost = self._remat(cost_span, warp_correlate.aggregate_cost_volume,
                                       feats[key], proj2, dv, impl)
                if self.warp_impl == "epipolar" and engaged is None:
                    engaged = torch.zeros((b, v - 1), dtype=torch.bool)
                return cost, engaged

            def regularize(cost: torch.Tensor, reg: nn.Module, p: str) -> torch.Tensor:
                x = cost.to(self.costreg_dtype).permute(0, 4, 1, 2, 3).contiguous()
                if band is not None:
                    x = spatial.take_rows(x, 3, band)
                out = self._remat(f"{name}.{p}.costreg", self._regularize, reg, x,
                                  band is not None)                # (B, 4, D, h, w)
                return out.permute(0, 2, 3, 4, 1)                  # (B, D, h, w, 4)

            def head(fn, cost_reg, dv, p: str):
                with span(f"{name}.{p}.head"):
                    if band is None:
                        return fn(cost_reg, dv, interval)
                    out = fn(cost_reg, spatial.take_rows(dv, 2, band), interval)
                    return {k: spatial.gather_rows(x, self.mesh, _HEAD_H_AXIS[k], bands)
                            if k in _HEAD_H_AXIS else x for k, x in out.items()}

            adaptive = self.agg_mode == "adaptive"
            # run_stages: where in this stage to stop (99: nowhere)
            frac = self.run_stages - s if self.run_stages else 99.0
            if frac <= 0.3:
                outputs["partial"] = samples
                break
            # pass 1: full-plane sweep
            cost, engaged = cost_volume(stage, "main", samples, self.epipolar_main_stages,
                                        self.agg_weight[s] if adaptive else None)
            if frac <= 0.5:
                outputs["partial"] = cost
                break
            cost_reg = regularize(cost, self.cost_regularization[s], "main")
            if frac <= 0.7:
                outputs["partial"] = cost_reg
                break
            stage_out = {**head(depth_net.forward, cost_reg, samples, "main"),
                         "depth_values": samples}

            # pass 2: 4-plane checkerboard refine on the "_c" features
            dv_c = stage_out["depth_values_c"]
            cost_c, engaged_c = cost_volume(stage + "_c", "refine", dv_c,
                                            self.epipolar_refine_stages,
                                            self.agg_weight_refine[s] if adaptive else None)
            if frac <= 0.85:
                outputs["partial"] = cost_c
                break
            cost_reg_c = regularize(cost_c, self.cost_regularization_refine[s], "refine")
            if frac <= 0.95:
                outputs["partial"] = cost_reg_c
                break
            refine_out = head(depth_net.refine, cost_reg_c, dv_c, "refine")
            if engaged is not None:
                refine_out["sweep_engaged"] = engaged
                refine_out["sweep_engaged_refine"] = engaged_c

            # first-pass keys win: the final photometric_confidence is the
            # stage-3 first-pass confidence, as in the reference
            stage_out = {**refine_out, **stage_out}
            last_depth = stage_out["depth"]
            outputs[stage] = stage_out
            outputs.update(stage_out)
            if self.run_stages and s + 1 >= self.run_stages:
                break
        return outputs

    def _remat(self, name: str, fn, *args):
        """``fn(*args)`` inside the span ``name``; under remat in train mode
        recomputed in the backward, span and all.  ``fn`` must read nothing
        but ``args`` and what stays fixed through the forward: the recompute
        runs after the stage loop has moved on."""
        if self.remat and self.training:
            return checkpoint(_spanned, name, fn, *args)
        return _spanned(name, fn, *args)

    @staticmethod
    def _regularize(reg: nn.Module, x: torch.Tensor, split: bool) -> torch.Tensor:
        """``reg(x)``, on this sp rank's band of rows where ``split``.  The
        flag is an argument, so that remat's recompute in the backward runs
        on the band too; its halo and batch-norm all_reduces are issued
        again then, in the same order on every rank, which keeps the
        collectives matched."""
        with spatial.split_rows(split):
            return reg(x)

    def _gate(self, name: str, weight_net: nn.Module, sim: torch.Tensor) -> torch.Tensor:
        """One view's (B, D, H, W, 2) fp32 correlation gated by the sigmoid
        of its weight net (fed in the compute dtype), inside the span
        ``name``."""
        with span(name):
            x = sim.to(self.compute_dtype).permute(0, 4, 1, 2, 3).contiguous()
            return sim * torch.sigmoid(weight_net(x).permute(0, 2, 3, 4, 1).float())


def _spanned(name: str, fn, *args):
    with span(name):
        return fn(*args)
