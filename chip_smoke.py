"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--grad-trials N]

(``--rank-task`` / ``--task-dir`` are for the ranks the script starts
itself under torchrun in phases 16-18, 23 and 25.)

``--grad-trials N`` repeats the gradient comparison of phase 6 on N freshly
seeded sets of weights and prints it, to show its spread; nothing is held
there.

Phases, in order; any failure raises and the script exits non-zero.  The
synthetic rows of phases 3, 4 and 7-9 run on two camera sets: "translate"
(x translation and 0.01 rad about y per view index) and "orbit" (views on an
arc around a point at depth 600, rotated by degrees about x, y and z:
utils/synthetic.orbit_camera_stack), each row naming its set:

1. the card (nvidia-smi name and power limit), torch / CUDA versions and
   the TF32 flags (pinned off: the port is held to the fp32 reference);
2. build of the six hand-written CUDA kernels from dmvsnet_tpu_torch/csrc/
   (one nvcc per source, started together);
3. the forward kernel vs its plain PyTorch version on the card at the six
   cost-pass shapes of DTU eval (864x1152, 5 views, batch 2, ndepths
   48/32/8 + the 4-plane refine passes): max |diff| against
   1e-4 * max(1, max|plain|), kernel and plain times (median of
   CUDA-event-timed runs) beside the least time the card could take (bytes
   over 3.35 TB/s, fp32 operations over 67 TFLOP/s: H100 SXM data sheet),
   where the samples fall;
4. the two adjoint kernels vs their plain version (autograd of the plain
   forward) at the six cost-pass shapes of DTU training (512x640, 5 views,
   batch 2), refine fans with zero and negative depths: max |diff| against
   1e-4 * max(1, max|plain|), no gradient for projections and depths, the
   run-to-run spread of the atomic scatter, times, bounds, the scatter's
   float4 atomic adds (issued, and taps * C/4 uncombined);
5. the eval main path: run_test through the CLI at --preset dtu_test on a
   synthetic 864x1152, 5-view scene (eval_batch 2: three dispatches, the
   last padded), with seeded random weights.  Checks every PFM, checks that
   the kernel launched exactly 6 cost passes x 3 dispatches, then checks
   one batch of the same model against the same model with plain cost
   passes, and that each stage's depths lie inside the hypotheses they
   were regressed from; run_test's params / FLOPs / bytes line is kept
   for phase 24 (its counted forward is one more launch set); the "main"
   line carries the convolution problems cuDNN searched in run_test
   ("conv_selections", ``blocks.conv_selections``);
   then kernel 1 as in phase 3 on the inputs that batch's six cost passes
   received ("inputs": "model eval");
6. the training main path: the CLI at --preset dtu_train (512x640, 5 views,
   batch 2, fp32, Adam) on a synthetic DTU training tree: 3 train steps, a
   checkpoint, one validation batch; launch counts exactly 6 forward + 6 +
   6 adjoint launches per train step and 6 forward per validation batch;
   a second Trainer resumes epoch and optimizer step; one step's loss and
   gradients under deterministic cuDNN as relative L2 differences over all
   parameters, the median and the worst parameter: the adjoint kernels
   against their plain version behind the same kernel forward, and the
   kernel path against the plain path beside what half an ulp of noise on
   the plain path's cost volumes does; 8 steps on one fixed batch must lower
   the loss; ms per step and peak memory;
   then kernels 1-3 as in phases 3 and 4 on the inputs one step's six cost
   passes received, forward and backward ("inputs": "model train");
7. the resample kernel vs its plain version at the four resamples of each
   of the six eval cost passes (4 fan coefficients, the feature width twice,
   2*D folded planes) on the rectification coordinates of the smoke's
   cameras: max |diff| against 1e-4 * max(1, max|plain|), kernel, plain and
   F.grid_sample times (the library call is timed here and used nowhere in
   the port), bound;
8. the 1-D sweep kernel vs its plain version at the six pass shapes,
   inverse-depth fans for the main passes and depth-affine refine fans that
   cross zero: same tolerance, times, bound;
9. an A/B per (stage, pass): the whole epipolar cost pass (gates, four
   resamples, sweep, view sum) against the exact kernel on the same inputs,
   with the flags, and against itself with the rectification's 3x3 algebra
   on the card instead of the host; one "ab" line per pass.  Then the
   per-view fallback at the stage-1 main shape: one source view of one batch
   element moves forward (epipole inside the image), so that pair goes
   through the exact kernel on a view subset; flags, launch counts and the
   cost against the sum of its parts; one "fallback" line;
10. the epipolar main path: the CLI with --test --preset dtu_test
   --warp_impl epipolar at full width with all six passes routed to the
   sweep; PFMs checked; launches of the resample, sweep and exact kernels
   equal to what the reported flags imply; at least one view engaged in
   every routed pass; then one batch of the epipolar model against the
   exact-kernel model (NUMERICS.json tol.epi_*) and against the same model
   with the plain versions of its kernels;
   then kernels 4 and 5 as in phases 7 and 8 on the inputs that one batch
   of the all-routed epipolar model gave them: the four resamples and the
   sweep of each of its six passes ("inputs": "model eval");
11. "gate", the port's counterpart of tests/test_geometry_gate.py: 80
   overfit steps of the port's train step on a 96x128, 4-view plane scene
   (kernels 1-3, counted), the CLI's --test with pcd in two worker processes
   forked after the card is in use, and eval_scan of the fused cloud
   against a 2 mm grid on the plane, held as the JAX gate holds it; then
   kernels 1-3 as in phases 3 and 4 on the tensors of the first overfit
   step's six cost passes ("inputs": "model gate");
12. "recipe_dtu": the CLI's --test --preset dtu_test with the preset's own
   pcd fusion on an 11-view 864x1152 scene, the gate's weights loaded
   strictly: 11 maps, 36 kernel-1 launches, a PLY that parses;
13. "vis": the CLI's --vis on one of those depth maps;
14. "recipe_tank": the CLI's --test --preset tank_test (11 views,
   1080x2048 snapped to 1056x2048, 64/32/8, dypcd) on a wide-baseline
   scene: 66 launches, peak device memory, seconds per map and of dypcd;
   then kernel 1 against its plain version on the six passes of one map
   (D = 64 / 32 / 8 and the refines; "inputs": "model tank");
15. "blendedmvs": the CLI at --preset blendedmvs_finetune on a synthetic
   576x768, 7-view BlendedMVS tree, resuming the weights alone of phase 6's
   checkpoint (equal before the first step): 3 steps and a validation
   batch, their launches, finite losses, ms per step; then kernels 1-3 on
   the tensors of the first step's six cost passes ("inputs": "model
   blendedmvs");
16. "dp_nccl": the training CLI under ``torchrun --nproc_per_node 1``
   (nccl, world size 1, the model in DDP) on phase 6's tree: cli.main in
   the rank (``--rank-task cli``): 3 steps, a validation batch, launches 6
   + 6 + 6 per step, a checkpoint with phase 6's reference names; then
   ``torchrun ... -m dmvsnet_tpu_torch.cli --resume`` as users launch it,
   one more epoch of one step, exit 0, epoch 1 and step 4 in its
   checkpoint;
17. "dp_gloo": two ranks on the one card over gloo (``--rank-task gloo``;
   NCCL refuses two ranks on one device): the Trainer at dtu_train on a dp
   mesh, resuming phase 6's checkpoint, one element of the validation batch
   per rank; one step under deterministic cuDNN against the one-process
   step on the joined batch: loss (LOSS_RTOL), gradients (PATH_GRAD_RTOL,
   beside phase 6's half-ulp yardstick), running statistics (STAT_RTOL),
   scalars and gradients identical on both ranks, 6 + 6 + 6 launches per
   rank; ms per step of the 2 ranks sharing one card over gloo and the
   bytes all-reduced per step;
18. "vp", the same two ranks: the dtu_test forward at 864x1152 (batch 2, two
   source views per rank) against the one-process model (depth 0.05 mm,
   confidence 1e-3), 6 kernel-1 launches per rank over 3 views each; then
   one vp train step at dtu_train held as in phase 17; then kernel 1 as in
   phase 3 on rank 0's six vp passes ("inputs": "model vp");
19. "bf16_eval": the CLI's --test --preset dtu_test on phase 5's scene and
   seeded weights twice, at --feature_dtype bfloat16 --costreg_dtype
   bfloat16 (the JAX package's eval policy on its TPU) and at
   --compute_dtype bfloat16: 18 kernel-1 launches each, depth and
   confidence against phase 5's fp32 maps within NUMERICS.json "tol"
   (mean 0.2 / p99 2 / max 10 mm, confidence mean 0.005), ms per map and
   peak memory beside the fp32 model's in the same call; then kernel 1 as
   in phase 3 on the bf16 features, upcast, that one batch's six cost
   passes received ("inputs": "model bf16 eval");
20. "bf16_train": one dtu_train step at --compute_dtype bfloat16 from phase
   6's weights on its validation batch, against the fp32 step under
   deterministic cuDNN: loss within 1e-2, gradients as relative L2
   differences beside phase 6's yardstick, the six cost passes' features
   bf16 with bf16, finite gradients, kernels 1-3 six launches each; ms per
   step and peak memory;
21. "remat": the same step with remat=True against remat=False: loss
   (LOSS_RTOL), gradients (PATH_GRAD_RTOL), running statistics within 1e-6 *
   max(1, |stat|), each updated once; kernel 1 launched 6 + 6 recomputed
   times; ms per step and peak memory of both;
22. "adaptive" (agg_mode="adaptive"): the CLI's dtu_test with seeded
   weights (one gated-pass launch per pass and dispatch; V-1 kernel-1
   launches per pass in the counted summary forward, which runs pair by
   pair), one batch on the kernel path against the plain path (depth
   0.05 mm, confidence 1e-3), ms per map; one
   dtu_train step from phase 6's weights with seeded weight nets, kernel
   against plain path (LOSS_RTOL; PATH_GRAD_RTOL over all parameters and
   for the median; each parameter within the worst-parameter bound or 10x
   what half an ulp of noise on the plain path's cost volumes does to it,
   since the weight nets' scale-free parameters have gradients that batch
   norm cancels), V-1 launches of kernels 1-3 per pass, ms per step;
23. "sp", the spatial mesh axis: gloo ranks sharing the card, each running
   the cost U-Nets on its band of rows with halo exchanges (``--rank-task
   sp`` / ``dpsp``).  sp = 2 eval: the dtu_test forward at 864x1152 (batch
   2, phase 5's scene and weights; bands of 112 + 104 / 216 + 216 / 432 +
   432 rows) against the one-process forward (depth 0.05 mm, confidence
   1e-3; mean / p99 / max beside NUMERICS.json "tol"), 6 kernel-1 launches
   per rank on the whole image, no unsplit pass.  sp = 2 and dp 2 x sp 2
   (4 ranks) train: the Trainer at dtu_train with --mesh_spatial 2
   resuming phase 6's checkpoint, one step on its validation batch under
   deterministic cuDNN, held as in phase 17, the sp ranks of one dp
   coordinate on the same samples.  The training CLI with --mesh_spatial 2
   in each of 2 ranks: one step, a validation batch, a checkpoint.  Per-rank
   peak memory beside one process's, all_reduce calls and bytes per kind
   (halo, gather, batch norm), launches per rank, ms of the ranks
   time-sharing the card;
24. "cost", the cost model (engine/profiler): params, FLOPs and bytes per
   map of the dtu_test forward (batch 2, phase 5's scene and weights) on
   the kernel path, the plain path (both equal) and the epipolar-routed
   model (equal FLOPs), by kind; FLOPs and bytes per dtu_train step (phase
   6's weights and validation batch, kernel and plain path equal); the
   rates these imply over phase 5's ms per map and phase 6's ms per step,
   against 67 TFLOP/s and 3.35 TB/s; a torch.profiler trace of one forward,
   which must name kernel 1 six times; phase 5's run_test line, which must
   have appeared once with this phase's count;
25. "fold", the folded level-0 plan (models/folded.py, MVSNet.fold_level0)
   against the unfolded one, every row with the card's name and power
   limit.  Eval, on phase 5's batch and weights, one model toggled between
   the plans: depth and confidence folded against unfolded (0.05 mm, 1e-3;
   mean / p99 / max beside NUMERICS.json "tol"), ms per map and peak memory
   under each, 6 kernel-1 launches under each, 37 folded convolutions per
   forward under True (the stage-3 main and the three refine passes x 2
   branches x 4, and 5 in the feature net; the stage-1 and stage-2 main
   passes declined by the shape rule, 4 branches) and none under None; a
   "fold_pass" row per (stage, pass) timing that pass's cost U-Net on the
   model's own cost volume unfolded and folded (folded also where the rule
   declines it); the feature net's ms under each plan.  Train: one dtu_train
   step from phase 6's weights on its validation batch under deterministic
   cuDNN, fold on against off (LOSS_RTOL, PATH_GRAD_RTOL beside phase 6's
   yardstick, STAT_RTOL), 6 + 6 + 6 launches, ms per step and peak memory
   under each.  bf16: one forward at --costreg_dtype bfloat16 with fold on
   against phase 5's fp32 maps (NUMERICS.json "tol"), beside phase 19's
   unfolded difference.  sp: one sp = 2 eval forward with fold on
   (``--rank-task spfold``) against the one-process folded forward (phase
   23's bounds).  Cost: phase 24's counts (a map, a train step) under the
   folded plan, equal to the unfolded counts;
26. "gated", the gated adaptive pass (csrc/warp_correlate_gated.cu) on
   one tank_adaptive map: the tank_test preset with agg_mode="adaptive" at
   1056x1920, 11 views, seeded weights, one eval forward whose six gated
   passes are captured (6 launches, no kernel-1 launch); per pass a "gated"
   row: the kernel against its plain version (1e-4 * max(1, max|plain|)),
   its time, the per-pair route's time on the same inputs (kernel 1 on each
   of the 10 pairs, the folded weight net's convolutions, sigmoid, product
   and sum: what the pass cost before) and the bound of kernel 1's count
   (``pass_cost``);
27. a "phases" line (wall seconds of each phase, and the convolution
   problems cuDNN searched over the whole smoke), a "kernels" JSON line
   (sums over the passes; bounds summed per pass; "model_ms" on the model's
   inputs, "orbit_ms" on the orbit cameras, for the first five kernels, and
   for the gated pass its "tank adaptive" rows with "pairs_ms"; launches
   on each recipe path and "recipe_model_ms" on the recipes' tensors;
   launches on the dp, vp and sp paths and "vp_model_ms"; launches on the
   model options' and the folded plan's paths and "bf16_eval_model_ms"; the
   scatter's atomic
   adds), the card line, and the final {"ok": true, "device": {...}} line.

A rank that fails or outlives RANKS_TIMEOUT_S fails its phase; torchrun
stops the other ranks, and the script stops every process it started.

Exits non-zero without a result when CUDA is unavailable, or when run
outside the repository (the port is not importable).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import signal
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from PIL import Image
from torch.nn.parallel import DistributedDataParallel

from dmvsnet_tpu_torch import pin_fp32, resolve_device
from dmvsnet_tpu_torch.core import epipolar, geometry, sampling
from dmvsnet_tpu_torch.config import preset
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
from dmvsnet_tpu_torch.data.loader import make_loader
from dmvsnet_tpu_torch.engine import checkpoint as ckpt_lib
from dmvsnet_tpu_torch.engine import evaluate, profiler
from dmvsnet_tpu_torch.engine.evaluate import build_model
from dmvsnet_tpu_torch.engine.state import make_lr_schedule, make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.engine.train import Trainer, build_model as build_train_model
from dmvsnet_tpu_torch.engine.train import data_parallel
from dmvsnet_tpu_torch.fusion import TANK_SCENE_CONFIG
from dmvsnet_tpu_torch.fusion.dtu_eval import eval_scan
from dmvsnet_tpu_torch.fusion.ply import read_ply
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.models import blocks, folded, mvsnet
from dmvsnet_tpu_torch.ops import cuda_build
from dmvsnet_tpu_torch.ops import epipolar_sweep as es
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.ops.warp_correlate import adjoint_cost, pass_cost
from dmvsnet_tpu_torch.parallel import (
    init_multihost,
    make_mesh,
    replicate_tree,
    shard_batch,
    spatial,
)
from dmvsnet_tpu_torch.parallel import mesh as mesh_lib
from dmvsnet_tpu_torch.utils import synthetic
from dmvsnet_tpu_torch import cli

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, V, B = 864, 1152, 5, 2
NDEPTHS = (48, 32, 8)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_S = 67e12      # H100 SXM fp32 without tensor cores
KERNEL_REPS, PLAIN_REPS = 20, 3
# back-to-back launches per timed sample of a kernel (with one launch per
# sample the wrapper's host work before a short kernel would be counted)
KERNEL_INNER = 10
TRAIN_H, TRAIN_W = 512, 640
# kernel-path vs plain-path train step, under deterministic cuDNN (without
# it cuDNN's weight-gradient kernels sum in an order that changes from run to
# run, and two runs of the plain path alone differ by 2e-3..4e-3 at their
# worst parameter).  Gradients are held as relative L2 differences: over all
# parameters together, for the median parameter and for the worst one.
# GRAD_RTOL holds the adjoint kernels: kernel forward with kernel adjoints
# against kernel forward with plain adjoints, so the forward is the same bit
# for bit and only kernels 2 and 3 differ (measured 2e-7..1e-6 over all
# parameters, 2e-6..6e-6 at the worst).  Kernel path against plain path
# cannot be held that tightly: the cost volumes agree to ~1e-6 and the network
# between them and a gradient (soft argmax, min/max composites, convolutions
# in front of train-mode batch norms) is ill-conditioned.  Half an ulp of
# relative noise on the plain path's cost volumes moves its own gradients as
# far as the kernel path is from it (the "yardstick" printed beside it): 1e-4
# over all parameters and 3e-3..9e-3 at the worst on the weights of this
# phase, 1e-3 and 1e-2..2e-2 on freshly seeded weights, with a heavy tail.  So
# PATH_GRAD_RTOL holds that comparison at the limits of
# tests/test_torch_train_step.py for the same quantity between the port and
# the JAX package, and the loss at LOSS_RTOL.
LOSS_RTOL = 1e-4
GRAD_RTOL = dict(all_parameters=1e-4, median_parameter=1e-4, worst_parameter=1e-3)
PATH_GRAD_RTOL = dict(all_parameters=5e-3, median_parameter=1e-3, worst_parameter=1e-1)
AB_REPS = 10
# the synthetic rows of phases 3, 4 and 7-9 run on both camera sets; the
# "kernels" line sums the "translate" rows (comparable with earlier runs) and
# gives the "orbit" rows' sums beside them
CAMERA_SETS = ("translate", "orbit")
PASS_NAMES = ("s1 main", "s1 refine", "s2 main", "s2 refine", "s3 main", "s3 refine")
# NUMERICS.json "tol": the epipolar model against the exact model
EPI_TOL = dict(mean_mm=0.5, p99_mm=5.0, max_mm=60.0, conf_mean=0.005)
# phases 11-15, the shipped test recipes: the geometry gate's scene and
# overfit (those of tests/test_geometry_gate.py), the 11-view DTU and T&T
# scenes (tank: 18 mm a view, as tools/tank_smoke.py, at the preset's largest
# resolution), the BlendedMVS fine-tune's low-res shape
GATE_H, GATE_W, GATE_V, PLANE_Z, GATE_STEPS = 96, 128, 4, 600.0, 80
RECIPE_V = 11
TANK_H, TANK_W, TANK_SNAP_H, TANK_BASELINE = 1080, 2048, 1056, 18.0
TANK_SCENE = "SyntheticWide"
# phase 26: one tank_adaptive map (the benchmark cell's 1056x1920, 11 views)
ADAPTIVE_H, ADAPTIVE_W = 1056, 1920
BMVS_H, BMVS_W, BMVS_V, BMVS_STEPS = 576, 768, 7, 3
BMVS_SCENE = "synthetic_plane"
# the "inputs" of the kernel rows on the recipes' own tensors (phases 11,
# 14 and 15): one pass set each, held like the others and reported in the
# "kernels" line's max_abs_err and recipe_model_ms
RECIPE_INPUTS = ("model gate", "model tank", "model blendedmvs")
# phases 16-18, data parallelism on the one card: the ranks of each path
# (torchrun's, killed at RANKS_TIMEOUT_S), and the running statistics' bound
# of tests/test_torch_train_step.py (1e-4 * max(1, max|stat|))
GLOO_RANKS, RANKS_TIMEOUT_S, STAT_RTOL = 2, 300.0, 1e-4
# phase 25: folded convolutions of one dtu_test forward under fold_level0=True
# (the stage-3 main pass and the three refine passes fold: 4 passes x 2
# branches x 4 convolutions, plus 5 in the feature net) and the U-Net
# branches the shape rule declines (the stage-1 and stage-2 main passes,
# 48 and 32 planes: 2 x 2)
FOLDED_CONVS, FOLDED_DECLINED = 4 * 2 * 4 + 5, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def host_and_card() -> dict:
    """What else loads the machine while ranks run: the host's 1-minute
    load average, this process's reserved device memory, and nvidia-smi's
    card-wide memory in use, utilisation, SM clock, power draw and
    temperature."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,utilization.gpu,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return dict(host_load_1min=os.getloadavg()[0], card=card,
                this_process_reserved_gb=torch.cuda.memory_reserved() / 1e9)


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over `reps` CUDA-event-timed samples, after one warm-up call,
    of the ms per call of `inner` back-to-back calls.  A kernel is timed
    with ``inner=KERNEL_INNER``: its wrapper's host work then overlaps the
    launches before it, and only the first call's reaches the sample."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stage_cameras(height: int = H, width: int = W,
                  cameras: str = "translate") -> dict[str, torch.Tensor]:
    """The smoke's batch-2, 5-view cameras per stage: "translate" (x
    translation and 0.01 rad about y per view index) or "orbit" (on an arc
    around a point at depth 600, rotated by degrees about x, y and z:
    utils/synthetic.orbit_camera_stack)."""
    cams = synthetic.camera_set(cameras, V, height, width, tx=-12.0)
    return {k: torch.from_numpy(np.broadcast_to(p, (B, *p.shape)).copy()).cuda()
            for k, p in synthetic.stage_projections(cams).items()}


def pass_cases(dev, height: int, width: int, cameras: str = "translate"):
    """The six cost passes of one batch-2, 5-view cascade at height x width
    as (name, C, feats, rel, depth): per stage the main sweep and a 4-plane
    refine fan spread far enough to reach zero and negative depths."""
    gen = torch.Generator(device=dev).manual_seed(0)
    projs = stage_cameras(height, width, cameras)
    depth_values = torch.from_numpy(
        (1.0 / np.linspace(1 / 500.0, 1 / 788.0, 192, endpoint=False)).astype(np.float32)
    )[None].repeat(B, 1).to(dev)
    for s, (c, nd) in enumerate(zip((32, 16, 8), NDEPTHS)):
        scale = 2 ** (2 - s)
        h, w = height // scale, width // scale
        feats = torch.randn((B, V, h, w, c), generator=gen, device=dev)
        rel = geometry.relative_projections(projs[f"stage{s + 1}"])
        main, _ = sampling.stage1_samples(depth_values, nd, h, w, inverse=True)
        fan = 600.0 + 400.0 * torch.randn((B, 4, h, w), generator=gen, device=dev)
        fan[:, 0, 0, :8] = 0.0  # the z == 0 guard
        if not bool((fan < 0).any()):
            raise AssertionError("refine fan has no negative depth")
        yield f"s{s + 1} main", c, feats, rel, main.contiguous()
        yield f"s{s + 1} refine", c, feats, rel, fan
        del feats
        torch.cuda.empty_cache()


def bound(row: dict) -> dict:
    """Adds the least time the card could take for row's bytes and flops."""
    row["bytes_ms"] = row["bytes"] / PEAK_BYTES_S * 1e3
    row["ops_ms"] = row["flops"] / PEAK_FP32_S * 1e3
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
    return row


def tap_stats(rel, depth, h: int, w: int) -> dict:
    """Where these inputs sample the source images: the share of samples
    inside the image, and the median |change| of a sample's x from one plane
    to the next (px), over views, planes and pixels."""
    inside, motion = [], []
    for i in range(rel.shape[1]):
        px, py = geometry.plane_sweep_coords(rel[:, i], depth, h, w)
        inside.append(((px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)).float().mean().item())
        if depth.shape[1] > 1:
            motion.append((px[:, 1:] - px[:, :-1]).abs().median().item())
        del px, py
    return dict(inside_share=statistics.mean(inside),
                motion_px_per_plane=statistics.median(motion) if motion else 0.0)


def forward_row(name: str, inputs: str, feats, rel, depth, plain_reps: int,
                cameras: str | None = None) -> dict:
    """Kernel 1 on one pass's inputs: against its plain version, its time
    (and the plain version's when ``plain_reps``), the bound, where the
    samples fall; synthetic inputs name their camera set."""
    b, v, h, w, c = feats.shape
    got = wc.warp_correlate(feats, rel, depth)
    want = wc.warp_correlate_plain(feats, rel, depth)
    torch.cuda.synchronize()
    err, tol = check_close(f"{name} ({inputs}) kernel 1", got, want)
    nbytes, flops = pass_cost(b, v, depth.shape[1], h, w, c)
    row = dict(pass_=name, inputs=inputs, **camera_key(cameras), C=c, D=depth.shape[1], H=h,
               W=w, max_abs_err=err, tol=tol,
               kernel_ms=time_ms(lambda: wc.warp_correlate(feats, rel, depth), KERNEL_REPS,
                                 KERNEL_INNER))
    if plain_reps:
        row["plain_ms"] = time_ms(lambda: wc.warp_correlate_plain(feats, rel, depth), plain_reps)
    row.update(bytes=nbytes, flops=flops, **tap_stats(rel, depth, h, w))
    print("pass " + json.dumps({k.rstrip("_"): v for k, v in bound(row).items()}), flush=True)
    return row


def camera_key(cameras: str | None) -> dict:
    return {} if cameras is None else {"cameras": cameras}


def kernel_vs_plain(dev) -> list[dict]:
    """Phase 3: the forward kernel against its plain version at the six
    eval pass shapes, under both camera sets."""
    rows = []
    for cameras in CAMERA_SETS:
        for name, c, feats, rel, depth in pass_cases(dev, H, W, cameras):
            rows.append(forward_row(name, "synthetic", feats, rel, depth, PLAIN_REPS, cameras))
    return rows


def count_taps(rel, depth, h: int, w: int) -> int:
    """Taps with a nonzero weight over every (view, plane, pixel): what the
    scatter kernel adds for these inputs (C scalars each)."""
    n = 0
    for i in range(rel.shape[1]):
        px, py = geometry.plane_sweep_coords(rel[:, i], depth, h, w)
        x, y = px.clamp(-2.0, w + 1.0), py.clamp(-2.0, h + 1.0)
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0
        for xi, wgx in ((x0, 1 - wx), (x0 + 1, wx)):
            for yi, wgy in ((y0, 1 - wy), (y0 + 1, wy)):
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                n += int((valid & (wgx * wgy != 0)).sum())
    return n


def plain_grad(feats, rel, depth, cot, wrt: str):
    """Autograd of the plain forward w.r.t. the reference slot ("ref") or
    the source slots ("src") alone: the plain version of one adjoint."""
    ref, src = feats[:, :1].detach(), feats[:, 1:].detach()
    leaf = (ref if wrt == "ref" else src).requires_grad_()
    out = wc.warp_correlate_plain(torch.cat([ref, src], 1), rel, depth)
    return torch.autograd.grad(out, leaf, cot)[0]


def adjoint_rows(name: str, inputs: str, feats, rel, depth, cot,
                 plain_reps: int, cameras: str | None = None) -> list[dict]:
    """Both adjoint kernels on one pass's inputs, through the
    autograd.Function: against autograd of the plain forward, no gradient
    for projections and depths, the run-to-run spread of the scatter, its
    counters, times, bounds."""
    b, v, h, w, c = feats.shape
    d = depth.shape[1]
    f, r, dep = (t.clone().requires_grad_() for t in (feats, rel, depth))
    wc.warp_correlate(f, r, dep).backward(cot)
    if r.grad is not None or dep.grad is not None:
        raise AssertionError(f"{name}: projections or depths received a gradient")
    got = f.grad
    want = wc.warp_correlate_grad_plain(feats, rel, depth, cot)
    stats = torch.zeros(2, dtype=torch.int64, device=feats.device)
    again = wc.warp_correlate_grad_src(feats, rel, depth, cot, stats=stats)
    torch.cuda.synchronize()
    taps = count_taps(rel, depth, h, w)
    costs = adjoint_cost(b, v, d, h, w, c, taps)
    buf = torch.empty_like(feats)
    rows = []
    for kernel, sl, wrt, fn in (
            ("warp_correlate_grad_ref", slice(0, 1), "ref", wc.warp_correlate_grad_ref),
            ("warp_correlate_grad_src", slice(1, None), "src", wc.warp_correlate_grad_src)):
        err = (got[:, sl] - want[:, sl]).abs().max().item()
        tol = 1e-4 * max(1.0, want[:, sl].abs().max().item())
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(f"{name} ({inputs}) {kernel}: max |diff| {err} > {tol}")
        row = dict(pass_=name, inputs=inputs, **camera_key(cameras), kernel=kernel, C=c, D=d,
                   H=h, W=w,
                   max_abs_err=err, tol=tol, max_abs_plain=want[:, sl].abs().max().item())
        if wrt == "src":
            # fp32 atomics: two runs of the same scatter differ in the last bits
            row["spread"] = (again[:, sl] - got[:, sl]).abs().max().item()
            if not row["spread"] <= tol:
                raise AssertionError(f"{name}: run-to-run spread {row['spread']} > {tol}")
            # taps * C/4: the float4 atomic adds of a scatter that combines
            # nothing, beside what this one issued
            row["taps"] = taps
            row["uncombined_atomic_adds"] = taps * c // 4
            row["global_atomic_adds"], row["cell_moves"] = stats.tolist()
        row["kernel_ms"] = time_ms(lambda: fn(feats, rel, depth, cot, buf), KERNEL_REPS,
                                   KERNEL_INNER)
        if plain_reps:
            row["plain_ms"] = time_ms(lambda: plain_grad(feats, rel, depth, cot, wrt), plain_reps)
        row["bytes"], row["flops"] = costs[kernel]
        print("adjoint " + json.dumps({k.rstrip("_"): v for k, v in bound(row).items()}),
              flush=True)
        rows.append(row)
    return rows


def adjoints_vs_plain(dev) -> list[dict]:
    """Phase 4: the adjoint kernels against autograd of the plain forward at
    the six train pass shapes, through the autograd.Function, under both
    camera sets."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for cameras in CAMERA_SETS:
        for name, c, feats, rel, depth in pass_cases(dev, TRAIN_H, TRAIN_W, cameras):
            cot = torch.randn((B, *depth.shape[1:], 2), generator=gen, device=dev)
            rows += adjoint_rows(name, "synthetic", feats, rel, depth, cot, PLAIN_REPS, cameras)
            del cot
    return rows


@contextlib.contextmanager
def capture_calls(module, attr: str, into: list, keep=lambda args: True, to=None):
    """Within the block ``module.<attr>`` appends a copy of its tensor
    arguments to ``into`` on every call for which ``keep(args)`` holds, then
    runs as before: the inputs the model's cost passes (or the kernels of
    its epipolar passes) really receive.  ``to="cpu"`` keeps the copies in
    host memory, out of the card's peak of the path that is measured."""
    saved = getattr(module, attr)

    def recording(*args):
        if keep(args):
            into.append(tuple(a.detach().to(to, copy=True) for a in args))
        return saved(*args)

    setattr(module, attr, recording)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def in_pass_order(captured: list) -> list:
    """The six captured passes of one forward or backward in forward order
    (a backward runs them in reverse): by falling C, then falling D."""
    if len(captured) != 6:
        raise AssertionError(f"captured {len(captured)} cost passes, expected 6")
    return sorted(captured, key=lambda t: (-t[0].shape[-1], -t[2].shape[1]))


def model_rows(captured: list, inputs: str) -> list[dict]:
    """Kernels 1-3 per pass on the tensors the model's cost passes received:
    kernel 1 on the six passes of one forward (captured calls of
    ``wc.warp_correlate``: feats, rel, depth), or kernels 1, 2 and 3 on
    those of one train step's backward (captured calls of
    ``wc.warp_correlate_grad``, which also carry the cotangent)."""
    rows = []
    for name, args in zip(PASS_NAMES, in_pass_order(captured)):
        args = [a.cuda() for a in args]
        with torch.inference_mode():
            rows.append(forward_row(name, inputs, *args[:3], 0))
        if len(args) == 4:
            rows += adjoint_rows(name, inputs, *args, 0)
    return rows


def first_pass_set(captured: list):
    """``keep`` for capture_calls: the first six calls, the cost passes of
    one forward (at eval batch 1, one map) or of one step's backward."""
    return lambda args: len(captured) < len(PASS_NAMES)


def check_pfms(out_dir: str, n_views: int) -> None:
    for v in range(n_views):
        for kind in ("depth_est", "confidence"):
            arr, _ = io.read_pfm(os.path.join(out_dir, "scan1", kind, f"{v:08d}.pfm"))
            if arr.shape != (H, W) or not np.isfinite(arr).all():
                raise AssertionError(f"{kind} view {v}: shape {arr.shape}, "
                                     f"finite {np.isfinite(arr).all()}")
        io.read_cam_file(os.path.join(out_dir, "scan1", "cams", f"{v:08d}_cam.txt"))
        if not os.path.exists(os.path.join(out_dir, "scan1", "images", f"{v:08d}.jpg")):
            raise AssertionError(f"images/{v:08d}.jpg missing")


def load_batch(cfg, dev):
    """The first batch of the eval scene on the card: imgs, proj, depth values."""
    ds = GeneralEvalDataset(cfg.datapath, ["scan1"], nviews=cfg.num_view,
                            ndepths=cfg.numdepth, interval_scale=cfg.interval_scale,
                            max_h=cfg.max_h, max_w=cfg.max_w, inverse_depth=cfg.inverse_depth)
    samples = [ds[i] for i in range(B)]
    imgs = torch.from_numpy(np.stack([s["imgs"] for s in samples])).to(dev)
    proj = {k: torch.from_numpy(np.stack([s["proj_matrices"][k] for s in samples])).to(dev)
            for k in samples[0]["proj_matrices"]}
    dv = torch.from_numpy(np.stack([s["depth_values"] for s in samples])).to(dev)
    return imgs, proj, dv


def check_batch(cfg, dev) -> tuple[dict, list]:
    """One batch of the main path: the kernel model vs the same weights with
    plain cost passes, the hypothesis envelopes, and steady-state times;
    also the inputs of the kernel model's six cost passes."""
    imgs, proj, dv = load_batch(cfg, dev)
    model = build_model(cfg, dev)
    if model.warp_impl != "cuda":
        raise AssertionError(f"main path resolved warp_impl={model.warp_impl!r}")

    def forward(impl):
        model.warp_impl = impl
        with torch.inference_mode():
            return model(imgs, proj, dv)

    captured = []
    with capture_calls(wc, "warp_correlate", captured):
        out_k = forward("cuda")
    out_p = forward("torch")
    torch.cuda.synchronize()
    d_err = (out_k["depth"] - out_p["depth"]).abs().max().item()
    c_err = (out_k["photometric_confidence"] - out_p["photometric_confidence"]).abs().max().item()
    if not (d_err <= 0.05 and c_err <= 1e-3):
        raise AssertionError(f"kernel vs plain model: depth {d_err} mm, conf {c_err}")
    for s in range(len(NDEPTHS)):
        st = out_k[f"stage{s + 1}"]
        for depth4, hyp in ((st["depth_sub_plus"], st["depth_values"]),
                            (st["depth_sub_plus_refine"], st["depth_values_c"])):
            lo = hyp.amin(1)[..., None] - 1e-3 * hyp.abs().amax(1)[..., None]
            hi = hyp.amax(1)[..., None] + 1e-3 * hyp.abs().amax(1)[..., None]
            if not bool(((depth4 >= lo) & (depth4 <= hi)).all()):
                raise AssertionError(f"stage{s + 1}: depth outside its hypotheses")
    if not bool(torch.isfinite(out_k["depth"]).all()):
        raise AssertionError("non-finite depth")
    kernel_ms = time_ms(lambda: forward("cuda"), 5)
    plain_ms = time_ms(lambda: forward("torch"), 3)
    model.warp_impl = "cuda"
    return dict(depth_max_abs_diff_mm=d_err, conf_max_abs_diff=c_err,
                forward_ms_kernel=kernel_ms, forward_ms_plain=plain_ms,
                ms_per_map_kernel=kernel_ms / B, ms_per_map_plain=plain_ms / B,
                depth_range_mm=[out_k["depth"].min().item(), out_k["depth"].max().item()]), captured


def pass_shapes():
    """(stage index, name, C, D, h, w) of the six eval cost passes."""
    for s, (c, nd) in enumerate(zip((32, 16, 8), NDEPTHS)):
        scale = 2 ** (2 - s)
        yield s, f"s{s + 1} main", c, nd, H // scale, W // scale
        yield s, f"s{s + 1} refine", c, 4, H // scale, W // scale


def smoke_fans(dev, gen, h: int, w: int, nd: int, refine: bool, zero_crossing: bool):
    """(B, D, h, w) hypotheses of one pass: the inverse-depth cascade fan of
    a main pass, or a per-pixel 4-plane fan that is arithmetic in depth
    (the refine checkerboard's structure; too wide for the inverse form).
    With ``zero_crossing`` the refine fans sit around depth 0."""
    if not refine:
        depth_values = torch.from_numpy(
            (1.0 / np.linspace(1 / 500.0, 1 / 788.0, 192, endpoint=False)).astype(np.float32)
        )[None].repeat(B, 1).to(dev)
        return sampling.stage1_samples(depth_values, nd, h, w, inverse=True)[0].contiguous()
    centre, spread = (20.0, 40.0) if zero_crossing else (600.0, 50.0)
    mid = centre + spread * torch.randn((B, 1, h, w), generator=gen, device=dev)
    step = 30.0 + 10.0 * torch.rand((B, 1, h, w), generator=gen, device=dev)
    ks = torch.arange(4, dtype=torch.float32, device=dev)[None, :, None, None] - 1.5
    return (mid + ks * step).contiguous()


def pair_geometry(dev, s: int, h: int, w: int, cameras: str = "translate"):
    """The N = B*(V-1) pairs of the smoke's cameras at stage s: relative
    projections (B, V-1, 3, 4), their Rectification, pair -> batch index."""
    rel = geometry.relative_projections(stage_cameras(cameras=cameras)[f"stage{s + 1}"])
    rect = epipolar.compute_rectification(rel.reshape(B * (V - 1), 3, 4), h, w)
    pb = torch.arange(B, device=dev).repeat_interleave(V - 1)
    return rel, rect, pb


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{name}: kernel vs plain max |diff| {err} > {tol}")
    return err, tol


def resample_row(name: str, what: str, inputs: str, img, px, py, plain_reps: int,
                 cameras: str | None = None) -> dict:
    """Kernel 4 on one resample's inputs: against its plain version, its
    time, the bound; with ``plain_reps`` also the plain version's time and
    F.grid_sample's (the library call: NCHW input and normalised
    coordinates made beforehand; timed here, used nowhere in the port)."""
    n, h, w, ch = img.shape
    got = es.resample(img, px, py)
    want = es.resample_plain(img, px, py)
    torch.cuda.synchronize()
    err, tol = check_close(f"{name} ({inputs}) resample {what}", got, want)
    row = dict(kernel="resample", pass_=name, inputs=inputs, **camera_key(cameras), what=what,
               N=n, C=ch, H=h, W=w,
               max_abs_err=err, tol=tol,
               outside_share=((px < 0) | (px > w - 1) | (py < 0) | (py > h - 1)).float().mean().item())
    if plain_reps:
        nchw = img.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([2.0 * px / (w - 1) - 1.0, 2.0 * py / (h - 1) - 1.0], dim=-1)

        def library():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        row["library_max_abs_diff"] = (library().permute(0, 2, 3, 1) - want).abs().max().item()
    del got, want
    row["kernel_ms"] = time_ms(lambda: es.resample(img, px, py), KERNEL_REPS, KERNEL_INNER)
    if plain_reps:
        row["plain_ms"] = time_ms(lambda: es.resample_plain(img, px, py), plain_reps)
        row["library_ms"] = time_ms(library, KERNEL_REPS, KERNEL_INNER)
        del nchw, grid
    row.update(bytes=4 * n * (h * w * ch + 2 * h * w + h * w * ch), flops=n * h * w * (8 * ch + 20))
    row = bound(row)
    print("resample " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
    return row


def resample_vs_plain(dev) -> list[dict]:
    """Phase 7: the resample kernel against its plain version and beside
    F.grid_sample at the four resamples of each eval cost pass, on the
    rectifications of both camera sets."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for cameras in CAMERA_SETS:
        for s, name, c, nd, h, w in pass_shapes():
            n = B * (V - 1)
            _, rect, _ = pair_geometry(dev, s, h, w, cameras)
            rxx, rxy = epipolar.rect_grid_coords(rect.h_ref, h, w)
            sxx, sxy = epipolar.rect_grid_coords(rect.h_src, h, w)
            ux, uy = epipolar.unrect_grid_coords(rect.h_ref, h, w)
            for what, ch, px, py in (("coeffs", 4, rxx, rxy), ("ref", c, rxx, rxy),
                                     ("src", c, sxx, sxy), ("unrect", 2 * nd, ux, uy)):
                img = torch.randn((n, h, w, ch), generator=gen, device=dev)
                rows.append(resample_row(name, what, "synthetic", img, px.contiguous(),
                                         py.contiguous(), PLAIN_REPS, cameras))
                del img
            torch.cuda.empty_cache()
    if not any(r["outside_share"] > 0 for r in rows):
        raise AssertionError("no resample coordinate left the image: zero padding untested")
    return rows


def sweep_row(name: str, inputs: str, src_r, ref_r, px, plain_reps: int,
              cameras: str | None = None) -> dict:
    """Kernel 5 on one pass's inputs: against its plain version, its time
    (and the plain version's when ``plain_reps``), the bound."""
    n, h, w, c = src_r.shape
    nd = px.shape[1]
    got = es.sweep1d(src_r, ref_r, px)
    want = es.sweep1d_plain(src_r, ref_r, px)
    torch.cuda.synchronize()
    err, tol = check_close(f"{name} ({inputs}) sweep1d", got, want)
    del got, want
    row = dict(kernel="sweep1d", pass_=name, inputs=inputs, **camera_key(cameras), N=n, C=c,
               D=nd, H=h, W=w,
               max_abs_err=err, tol=tol,
               outside_share=((px < 0) | (px > w - 1)).float().mean().item(),
               kernel_ms=time_ms(lambda: es.sweep1d(src_r, ref_r, px), KERNEL_REPS, KERNEL_INNER))
    if plain_reps:
        row["plain_ms"] = time_ms(lambda: es.sweep1d_plain(src_r, ref_r, px), plain_reps)
    row.update(bytes=4 * n * (2 * h * w * c + 3 * nd * h * w), flops=n * nd * h * w * (5 * c + 10))
    row = bound(row)
    print("sweep1d " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
    return row


def sweep_vs_plain(dev) -> list[dict]:
    """Phase 8: the 1-D sweep kernel against its plain version at the six
    pass shapes, on coordinates made as the path makes them from both camera
    sets."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for cameras in CAMERA_SETS:
        for s, name, c, nd, h, w in pass_shapes():
            n = B * (V - 1)
            refine = name.endswith("refine")
            _, rect, pb = pair_geometry(dev, s, h, w, cameras)
            dv = smoke_fans(dev, gen, h, w, nd, refine, zero_crossing=True)
            if refine and not bool((dv < 0).any() and (dv > 0).any()):
                raise AssertionError(f"{name}: refine fan does not cross zero")
            coeffs0, inv_ok, dep_ok = es._fan_coeffs(dv)
            if not (refine or bool(inv_ok.all())):
                raise AssertionError(f"{name}: the cascade fan does not fit the inverse form")
            del inv_ok, dep_ok
            coeffs = es.resample(coeffs0[pb], *(t.contiguous() for t in
                                                epipolar.rect_grid_coords(rect.h_ref, h, w)))
            px = es._fan_px(rect, coeffs, [not refine] * n, nd, h, w).contiguous()
            src_r, ref_r = (torch.randn((n, h, w, c), generator=gen, device=dev)
                            for _ in range(2))
            rows.append(sweep_row(name, "synthetic", src_r, ref_r, px, PLAIN_REPS, cameras))
            del src_r, ref_r, px, coeffs, coeffs0, dv
            torch.cuda.empty_cache()
    return rows


def epipolar_model_rows(resamples: list, sweeps: list) -> list[dict]:
    """Kernels 4 and 5 as in phases 7 and 8 on the tensors that one batch
    of the all-routed epipolar model gave them (``inputs`` "model eval"):
    per routed pass its four resamples (fan coefficients, reference,
    source, un-rectify) and its sweep, in the order the pass makes them."""
    if len(sweeps) != len(PASS_NAMES) or len(resamples) != 4 * len(sweeps):
        raise AssertionError(f"captured {len(resamples)} resamples and {len(sweeps)} sweeps, "
                             f"expected 24 and 6")
    order = sorted(range(len(sweeps)), key=lambda i: (-sweeps[i][0].shape[-1],
                                                      -sweeps[i][2].shape[1]))
    rows = []
    with torch.inference_mode():
        for j, i in enumerate(order):
            for what, args in zip(("coeffs", "ref", "src", "unrect"), resamples[4 * i:4 * i + 4]):
                rows.append(resample_row(PASS_NAMES[j], what, "model eval", *args, 0))
            rows.append(sweep_row(PASS_NAMES[j], "model eval", *sweeps[i], 0))
    return rows


def gate_decisions(rel, h: int, w: int) -> dict:
    """What the geometry gates of ops/epipolar_sweep see for each of the
    B*(V-1) pairs: the epipole's distance from the source image centre in
    image diagonals (the sweep needs more than EPIPOLE_MARGIN) and the
    rectification's three scale factors (each inside (SCALE_MIN, SCALE_MAX))."""
    rect = epipolar.compute_rectification(rel.reshape(-1, *rel.shape[2:]).cpu(), h, w)
    diag = float((h * h + w * w) ** 0.5)
    return dict(epipole_dist_diagonals=[round(x, 3) for x in (rect.epipole_dist / diag).tolist()],
                scales=[[round(x, 3) for x in row] for row in rect.scales.tolist()],
                epipole_margin=es.EPIPOLE_MARGIN, scale_range=[es.SCALE_MIN, es.SCALE_MAX])


def ab_per_pass(dev) -> list[dict]:
    """Phase 9: per (stage, pass) and camera set, the whole epipolar cost
    pass against the exact kernel on the same inputs, and against itself
    with the rectification's 3x3 algebra on the card (CUDA-event ms, median
    of AB_REPS; the epipolar pass includes its gates and their one host
    read); the orbit rows also print the gates' inputs."""
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for cameras, (s, name, c, nd, h, w) in ((k, p) for k in CAMERA_SETS for p in pass_shapes()):
        projs = stage_cameras(cameras=cameras)
        feats = torch.randn((B, V, h, w, c), generator=gen, device=dev)
        proj2 = projs[f"stage{s + 1}"]
        dv = smoke_fans(dev, gen, h, w, nd, name.endswith("refine"), zero_crossing=False)
        with torch.inference_mode():
            def sweep():
                return es.aggregate_cost_volume_epipolar(feats, proj2, dv)

            def sweep_card():
                with rectification_on_the_card():
                    return sweep()

            cost, flags = sweep()
            exact = wc.aggregate_cost_volume(feats, proj2, dv)
            cost_card, flags_card = sweep_card()
            torch.cuda.synchronize()
            if not torch.equal(flags, flags_card):
                raise AssertionError(f"{name}: flags {flags.tolist()} with the rectification on "
                                     f"the host, {flags_card.tolist()} with it on the card")
            diff = (cost - exact).abs()
            row = dict(pass_=name, cameras=cameras, stage=s, refine=name.endswith("refine"), C=c,
                       D=nd, H=h, W=w, engaged=flags.tolist(),
                       mean_abs_diff_vs_exact=diff.mean().item(),
                       max_abs_exact=exact.abs().max().item(),
                       mean_abs_diff_rectification_on_card=(cost_card - cost).abs().mean().item())
            del cost, exact, diff, cost_card
            # exact, host, card, card, host, exact: both orders within one process
            t = [time_ms(lambda: wc.aggregate_cost_volume(feats, proj2, dv), AB_REPS),
                 time_ms(sweep, AB_REPS), time_ms(sweep_card, AB_REPS),
                 time_ms(sweep_card, AB_REPS), time_ms(sweep, AB_REPS),
                 time_ms(lambda: wc.aggregate_cost_volume(feats, proj2, dv), AB_REPS)]
        if name.endswith("refine") != (not any(es._fan_coeffs(dv)[1].tolist())):
            raise AssertionError(f"{name}: fan mode is not the one this pass is meant to time")
        row.update(exact_ms=(t[0] + t[5]) / 2, epipolar_ms=(t[1] + t[4]) / 2,
                   epipolar_ms_rectification_on_card=(t[2] + t[3]) / 2, runs_ms=t)
        row["sweep_wins"] = bool(flags.all()) and row["epipolar_ms"] < row["exact_ms"]
        if cameras == "orbit":
            row["gates"] = gate_decisions(geometry.relative_projections(proj2), h, w)
        print("ab " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
        rows.append(row)
        del feats, dv
        torch.cuda.empty_cache()
    return rows


def fallback_case(dev) -> dict:
    """Phase 9, second part: the per-view fallback on the card at the
    stage-1 main shape.  Source view 3 of batch element 1 is the reference
    camera moved forward (epipole inside the image), so the gate sends that
    pair through the exact kernel on a view subset while the other seven
    take the sweep.  Checks the flags, the launch counts they imply, and the
    cost against the sum of its parts (sweep of the engaged views alone plus
    the exact kernel on the fallback view alone)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    s, name, c, nd, h, w = next(iter(pass_shapes()))
    feats = torch.randn((B, V, h, w, c), generator=gen, device=dev)
    dv = smoke_fans(dev, gen, h, w, nd, refine=False, zero_crossing=False)
    proj2 = stage_cameras()[f"stage{s + 1}"].clone()
    bi, view = 1, 3
    proj2[bi, view, 0] = proj2[bi, 0, 0]
    proj2[bi, view, 0, :3, 3] += torch.tensor([0.5, 0.3, -40.0], device=dev)
    want_flags = torch.ones((B, V - 1), dtype=torch.bool)
    want_flags[bi, view - 1] = False
    others = [v for v in range(V) if v != view]
    with torch.inference_mode():
        cuda_build.reset_launches()
        cost, flags = es.aggregate_cost_volume_epipolar(feats, proj2, dv)
        launches = cuda_build.launches()
        expected = dict.fromkeys(launches, 0)
        expected.update(resample=4, sweep1d=1, warp_correlate=1)
        if not torch.equal(flags, want_flags) or launches != expected:
            raise AssertionError(f"fallback case: flags {flags.tolist()} (expected "
                                 f"{want_flags.tolist()}), launches {launches} (expected "
                                 f"{expected})")
        parts = torch.empty_like(cost)
        parts[0], all_engaged = (t[0] for t in es.aggregate_cost_volume_epipolar(
            feats[:1], proj2[:1], dv[:1]))
        swept, engaged = es.aggregate_cost_volume_epipolar(
            feats[bi:bi + 1, others], proj2[bi:bi + 1, others], dv[bi:bi + 1])
        rel = geometry.relative_projections(proj2[bi:bi + 1, [0, view]])
        parts[bi] = swept[0] + wc.warp_correlate(
            feats[bi:bi + 1, [0, view]].contiguous(), rel, dv[bi:bi + 1])[0]
        torch.cuda.synchronize()
        if not (bool(all_engaged.all()) and bool(engaged.all())):
            raise AssertionError("fallback case: a part did not take the sweep")
        err, tol = check_close("fallback case, cost vs the sum of its parts", cost, parts)
        exact = wc.aggregate_cost_volume(feats, proj2, dv)
        row = dict(pass_=name, C=c, D=nd, H=h, W=w, engaged=flags.tolist(), launches=launches,
                   max_abs_err_vs_parts=err, tol=tol,
                   mean_abs_diff_vs_exact=(cost - exact).abs().mean().item(),
                   ms=time_ms(lambda: es.aggregate_cost_volume_epipolar(feats, proj2, dv), AB_REPS),
                   exact_ms=time_ms(lambda: wc.aggregate_cost_volume(feats, proj2, dv), AB_REPS))
    print("fallback " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
    return row


def implied_launches(engaged: list[dict]) -> dict[str, int]:
    """The launches that the flags of a run of the epipolar path imply: per
    routed pass with an engaged pair 4 resamples and 1 sweep, plus one call
    of the exact kernel per batch element with a fallback view; a pass
    without an engaged pair is one call of the exact kernel."""
    n = dict.fromkeys(cuda_build.launches(), 0)
    for dispatch in engaged:
        for key, flags in dispatch.items():
            if not any(any(row) for row in flags):
                raise AssertionError(f"{key}: no view took the sweep ({flags})")
            n["resample"] += 4
            n["sweep1d"] += 1
            n["warp_correlate"] += sum(1 for row in flags if not all(row))
    return n


@contextlib.contextmanager
def plain_versions():
    """Within the block the epipolar path runs the plain versions of its
    three kernels on CUDA tensors (only to compare the kernels with them)."""
    saved = es.resample, es.sweep1d, wc.warp_correlate
    es.resample, es.sweep1d = es.resample_plain, es.sweep1d_plain
    wc.warp_correlate = wc.warp_correlate_plain
    try:
        yield
    finally:
        es.resample, es.sweep1d, wc.warp_correlate = saved


def device_gates(rel, inv_ok, dep_ok, h: int, w: int):
    """es._host_gates with the rectification's 3x3 algebra on the card: the
    gates are computed there and read back as one small tensor.  Timed by
    the A/B against the port's choice (the algebra on the host)."""
    b, nv = rel.shape[:2]
    rect = epipolar.compute_rectification(rel.reshape(b * nv, *rel.shape[2:]), h, w)
    ok, mode = es._gates(rect, inv_ok, dep_ok, nv, h, w)
    host = torch.stack([ok, mode]).cpu()
    return rect, (host[0], host[1])


@contextlib.contextmanager
def plain_adjoints():
    """Within the block the backward of the kernel cost pass is the plain
    version of its two adjoint kernels (autograd of the plain forward); the
    forward stays kernel 1."""
    saved = wc.warp_correlate_grad
    wc.warp_correlate_grad = wc.warp_correlate_grad_plain
    try:
        yield
    finally:
        wc.warp_correlate_grad = saved


@contextlib.contextmanager
def ulp_noise_on_plain_cost_volumes():
    """Within the block the plain cost pass returns its volume times
    (1 + 2^-24 * n), n standard normal from a seed: half an ulp of relative
    noise, the least that another summation order produces.  A yardstick for
    what the network between a cost volume and a gradient does to such a
    difference; used by the train phase, never by the port."""
    saved = wc.warp_correlate_plain
    gen = torch.Generator(device="cuda").manual_seed(7)

    def noisy(feats, rel, depth):
        out = saved(feats, rel, depth)
        return out * (1.0 + 2.0 ** -24 * torch.randn(out.shape, generator=gen, device=out.device))

    wc.warp_correlate_plain = noisy
    try:
        yield
    finally:
        wc.warp_correlate_plain = saved


@contextlib.contextmanager
def rectification_on_the_card():
    saved = es._host_gates
    es._host_gates = device_gates
    try:
        yield
    finally:
        es._host_gates = saved


def epipolar_path(dev, tmp: str) -> tuple[dict, dict, list]:
    """Phase 10: the CLI with --warp_impl epipolar at the full dtu_test
    preset with all six passes routed to the sweep, then one batch of that
    model against the exact-kernel model and against its plain versions,
    and the inputs its resample and sweep kernels received in that batch."""
    argv = ["--test", "--preset", "dtu_test", "--datapath", os.path.join(tmp, "data"),
            "--testlist", "scan1", "--outdir", os.path.join(tmp, "out_epipolar"),
            "--filter_method", "none", "--eval_batch", str(B), "--warp_impl", "epipolar"]
    saved = mvsnet.EPIPOLAR_MAIN_STAGES, mvsnet.EPIPOLAR_REFINE_STAGES
    mvsnet.EPIPOLAR_MAIN_STAGES = mvsnet.EPIPOLAR_REFINE_STAGES = (0, 1, 2)
    try:
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        summary = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_build.launches()
        # run_test's counted forward runs the first batch: its flags are
        # the first dispatch's
        expected = implied_launches(summary["sweep_engaged"][:1] + summary["sweep_engaged"])
        if (summary["maps"] != V or len(summary["sweep_engaged"]) != -(-V // B)
                or any(len(d) != 6 for d in summary["sweep_engaged"]) or launches != expected):
            raise AssertionError(f"epipolar path: {summary['maps']} maps, launches {launches}, "
                                 f"the flags imply {expected}: {summary['sweep_engaged']}")
        check_pfms(os.path.join(tmp, "out_epipolar"), V)

        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        model = build_model(cfg, dev)
        if (model.warp_impl, model.epipolar_main_stages, model.epipolar_refine_stages) != (
                "epipolar", (0, 1, 2), (0, 1, 2)):
            raise AssertionError(f"epipolar path resolved {model.warp_impl!r}, "
                                 f"{model.epipolar_main_stages}, {model.epipolar_refine_stages}")
    finally:
        mvsnet.EPIPOLAR_MAIN_STAGES, mvsnet.EPIPOLAR_REFINE_STAGES = saved
    imgs, proj, dv = load_batch(cfg, dev)

    def forward(impl):
        model.warp_impl = impl
        with torch.inference_mode():
            return model(imgs, proj, dv)

    out_e, out_c = forward("epipolar"), forward("cuda")
    with plain_versions():
        out_p = forward("epipolar")
    torch.cuda.synchronize()
    diff = (out_e["depth"] - out_c["depth"]).abs().flatten()
    vs_exact = dict(
        mean_mm=diff.mean().item(), max_mm=diff.max().item(),
        p99_mm=diff.kthvalue(int(0.99 * diff.numel())).values.item(),
        conf_mean=(out_e["photometric_confidence"]
                   - out_c["photometric_confidence"]).abs().mean().item())
    if not (all(np.isfinite(v) and v <= EPI_TOL[k] for k, v in vs_exact.items())
            and bool(torch.isfinite(out_e["depth"]).all())):
        raise AssertionError(f"epipolar vs exact model: {vs_exact} against {EPI_TOL}")
    d_err = (out_e["depth"] - out_p["depth"]).abs().max().item()
    c_err = (out_e["photometric_confidence"] - out_p["photometric_confidence"]).abs().max().item()
    flags_equal = all(torch.equal(out_e[f"stage{s + 1}"][k], out_p[f"stage{s + 1}"][k])
                      for s in range(3) for k in ("sweep_engaged", "sweep_engaged_refine"))
    if not (d_err <= 0.05 and c_err <= 1e-3 and flags_equal):
        raise AssertionError(f"epipolar kernels vs plain versions: depth {d_err} mm, conf "
                             f"{c_err}, flags equal {flags_equal}")
    del out_p
    resamples, sweeps = [], []
    with capture_calls(es, "resample", resamples), capture_calls(es, "sweep1d", sweeps):
        forward("epipolar")
    routed_ms = time_ms(lambda: forward("epipolar"), 5)
    exact_ms = time_ms(lambda: forward("cuda"), 5)
    model.epipolar_main_stages = mvsnet.EPIPOLAR_MAIN_STAGES
    model.epipolar_refine_stages = mvsnet.EPIPOLAR_REFINE_STAGES
    default_ms = time_ms(lambda: forward("epipolar"), 5)
    d = summary["dispatch_seconds"]
    return dict(
        maps=summary["maps"], launches=launches, run_test_wall_s=wall, dispatch_s=d,
        engaged_first_dispatch=summary["sweep_engaged"][0],
        all_engaged=all(all(all(r) for r in f) for disp in summary["sweep_engaged"]
                        for f in disp.values()),
        depth_vs_exact=vs_exact, depth_kernels_vs_plain_mm=d_err, conf_kernels_vs_plain=c_err,
        forward_ms_all_six_routed=routed_ms, forward_ms_exact=exact_ms,
        forward_ms_default_routing=default_ms,
        default_routing=[list(mvsnet.EPIPOLAR_MAIN_STAGES),
                         list(mvsnet.EPIPOLAR_REFINE_STAGES)]), launches, (resamples, sweeps)


def grad_diff(got: dict, want: dict) -> dict:
    """Relative L2 differences of two gradient sets: over all parameters,
    the median and the worst parameter."""
    per = sorted(((got[n] - g).norm().item() / max(g.norm().item(), 1e-30), n)
                 for n, g in want.items())
    num = sum((got[n] - g).double().square().sum().item() for n, g in want.items())
    den = sum(g.double().square().sum().item() for g in want.values())
    return dict(all_parameters=(num / den) ** 0.5, median_parameter=per[len(per) // 2][0],
                worst_parameter=per[-1][0], worst_name=per[-1][1])


def eval_argv(tmp: str) -> list[str]:
    """The CLI arguments of phase 5 (dtu_test on its 5-view scene)."""
    return ["--test", "--preset", "dtu_test", "--datapath", os.path.join(tmp, "data"),
            "--testlist", "scan1", "--outdir", os.path.join(tmp, "out"),
            "--filter_method", "none", "--eval_batch", str(B)]


def train_argv(tmp: str, log_dir: str = "logs") -> list[str]:
    """The CLI arguments of phase 6 (dtu_train on its tree: 6 train and 2
    validation samples, one epoch), logging to tmp/log_dir."""
    return ["--preset", "dtu_train", "--datapath", os.path.join(tmp, "dtu"),
            "--trainlist", "scan1", "--testlist", "scan1",
            "--log_dir", os.path.join(tmp, log_dir), "--max_train_samples", "6",
            "--max_val_samples", "2", "--epochs", "1", "--summary_freq", "1"]


def train_path(dev, tmp: str, grad_trials: int = 0) -> tuple[dict, dict, list]:
    """Phase 6: the trainer at the full dtu_train preset through the CLI,
    resume, kernel-path vs plain-path step (printed again for ``grad_trials``
    fresh sets of weights), the inputs of one step's six backward cost
    passes, and an 8-step overfit."""
    t0 = time.perf_counter()
    data = os.path.join(tmp, "dtu")
    synthetic.write_dtu_training_tree(data, scans=("scan1",), n_views=V, height=TRAIN_H,
                                      width=TRAIN_W, seed=0)
    print(f"training tree: {time.perf_counter() - t0:.2f}s", flush=True)
    argv = train_argv(tmp)
    steps, val_batches = 3, 1
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    summary = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_build.launches()
    expected = {"warp_correlate": 6 * (steps + val_batches),
                "warp_correlate_grad_ref": 6 * steps, "warp_correlate_grad_src": 6 * steps,
                "resample": 0, "sweep1d": 0, "gated_warp_correlate": 0}
    if summary["step"] != steps or launches != expected:
        raise AssertionError(f"train path: {summary['step']} steps, launches {launches} "
                             f"(expected {steps} and {expected})")
    epoch = summary["history"][0]
    for avg in (epoch["train_avg"], epoch["val_avg"]):
        if not all(np.isfinite(v) for v in avg.values()):
            raise AssertionError(f"train path: non-finite scalars {avg}")

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    latest = ckpt_lib.latest_checkpoint(cfg.log_dir)
    if latest != epoch["checkpoint"]:
        raise AssertionError(f"checkpoint {epoch['checkpoint']} is not the latest ({latest})")
    trainer = Trainer(cfg.replace(resume=latest))
    opt_steps = {int(st["step"]) for st in trainer.optimizer.state_dict()["state"].values()}
    if (trainer.start_epoch, trainer.step, opt_steps) != (1, steps, {steps}):
        raise AssertionError(f"resume: epoch {trainer.start_epoch}, step {trainer.step}, "
                             f"optimizer steps {opt_steps}")

    model = trainer.model
    if model.warp_impl != "cuda" or trainer.device.type != "cuda":
        raise AssertionError(f"trainer resolved {model.warp_impl!r} on {trainer.device}")
    batch = trainer.to_device(next(iter(trainer.val_loader)))

    def loss_and_grads(model, impl):
        model.warp_impl = impl
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss = mvs_loss(out, batch["depth"], batch["mask"], cfg.depth_mode, tuple(cfg.dlossw))
        loss.backward()
        model.warp_impl = "cuda"
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    def compare(model) -> dict:
        """One step's loss and gradients on ``model`` under deterministic
        cuDNN, four ways: the kernel path; the kernel forward with the plain
        adjoints; the plain path; the plain path with half an ulp of noise on
        its cost volumes.  "adjoints" isolates kernels 2 and 3 (the forward
        is the same bit for bit); "paths" is kernel path against plain path,
        "yardstick" what the noise alone does to the plain path."""
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            loss_k, grads_k = loss_and_grads(model, "cuda")
            with plain_adjoints():
                adjoints = grad_diff(grads_k, loss_and_grads(model, "cuda")[1])
            loss_p, grads_p = loss_and_grads(model, "torch")
            paths = grad_diff(grads_k, grads_p)
            del grads_k
            with ulp_noise_on_plain_cost_volumes():
                yardstick = grad_diff(loss_and_grads(model, "torch")[1], grads_p)
        finally:
            torch.backends.cudnn.deterministic = saved
        return dict(loss_kernel=loss_k, loss_plain=loss_p,
                    loss_rel_diff=abs(loss_k - loss_p) / abs(loss_p),
                    adjoints=adjoints, paths=paths, yardstick=yardstick)

    def within(diff: dict, limits: dict) -> bool:
        return all(np.isfinite(diff[k]) and diff[k] <= tol for k, tol in limits.items())

    held = compare(model)
    print("grad " + json.dumps(dict(weights="resumed", **held)), flush=True)
    if not (np.isfinite(held["loss_kernel"]) and held["loss_rel_diff"] <= LOSS_RTOL
            and within(held["adjoints"], GRAD_RTOL) and within(held["paths"], PATH_GRAD_RTOL)):
        raise AssertionError(f"kernel vs plain train step: {held} against loss {LOSS_RTOL}, "
                             f"adjoints {GRAD_RTOL}, paths {PATH_GRAD_RTOL}")
    # for the record only: the same on freshly seeded weights
    for seed in range(cfg.seed, cfg.seed + grad_trials):
        fresh = build_train_model(cfg.replace(seed=seed), dev)
        print("grad " + json.dumps(dict(weights=f"seed {seed}", **compare(fresh))), flush=True)
        del fresh

    train_step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for _ in range(8):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        scalars, _ = train_step(model, trainer.optimizer, trainer.scheduler, batch)
        end.record()
        losses.append(scalars["loss"])
        events.append((start, end))
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8 steps on one batch did not lower the loss: {losses}")
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    captured = []
    with capture_calls(wc, "warp_correlate_grad", captured):
        loss_and_grads(model, "cuda")
    return dict(
        steps=summary["step"], launches=launches, cli_wall_s=wall, checkpoint=latest,
        train_avg=epoch["train_avg"], val_avg=epoch["val_avg"],
        resumed_epoch=trainer.start_epoch, resumed_step=steps,
        loss_kernel=held["loss_kernel"], loss_plain=held["loss_plain"],
        loss_rel_diff=held["loss_rel_diff"],
        grad_rel_l2_diff_adjoints=held["adjoints"], grad_rel_l2_diff_paths=held["paths"],
        grad_rel_l2_diff_yardstick=held["yardstick"],
        overfit_losses=losses,
        train_step_ms=statistics.median(s.elapsed_time(e) for s, e in events[1:]),
        peak_mem_gb=peak_mem_gb), launches, captured


def run_test_forwards(dispatches: int) -> int:
    """Forwards of one run_test: one per dispatch, and one more of the first
    batch for its params / FLOPs / bytes line (engine/profiler.model_summary
    counts a real call)."""
    return dispatches + 1


def expect_launches(what: str, got: dict, **want: int) -> None:
    """Raises unless the launch counts ``got`` are ``want`` (0 for every
    kernel not named)."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{what}: launches {got}, expected {full}")


def geometry_gate(dev, tmp: str, num_worker: int = 2) -> tuple[dict, str]:
    """Phase 11, the port's counterpart of tests/test_geometry_gate.py:
    overfit the model for GATE_STEPS steps of the port's train step on a
    synthetic plane scene (96x128, 4 views, plane at z = 600), run the CLI's
    --test on it with pcd fusion in ``num_worker`` processes (forked after
    the card is in use: they touch only numpy), then DTU-protocol
    eval_scan of the fused cloud against a 2 mm grid on the plane.  Holds
    what the JAX gate holds.  Returns the line and the trained weights' path
    (a weights-only file).  Runs on the CPU too (tests/test_torch_geometry_gate.py)."""
    t0 = time.perf_counter()
    datapath, outdir = os.path.join(tmp, "gate_data"), os.path.join(tmp, "gate_out")
    synthetic.write_eval_scene(datapath, "scan1", height=GATE_H, width=GATE_W, n_views=GATE_V,
                               depth=PLANE_Z)
    argv = ["--test", "--dataset_name", "general_eval", "--datapath", datapath,
            "--outdir", outdir, "--testlist", "scan1", "--ndepths", "8", "8", "8",
            "--interval_ratio", "4", "2", "1", "--numdepth", "32", "--max_h", str(GATE_H),
            "--max_w", str(GATE_W), "--num_view", str(GATE_V), "--inverse_depth",
            "--filter_method", "pcd", "--thres_view", "2", "--conf", "0", "0", "0",
            "--num_worker", str(num_worker), "--device", dev.type]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    sample = GeneralEvalDataset(datapath, ["scan1"], nviews=GATE_V, ndepths=cfg.numdepth,
                                max_h=GATE_H, max_w=GATE_W, inverse_depth=True)[0]

    def on_dev(x):
        return torch.from_numpy(np.asarray(x)[None]).to(dev)

    scales = ((1, 4), (2, 2), (3, 1))
    batch = {"imgs": on_dev(sample["imgs"]),
             "proj_matrices": {k: on_dev(v) for k, v in sample["proj_matrices"].items()},
             "depth_values": on_dev(sample["depth_values"]),
             "depth": {f"stage{st}": torch.full((1, GATE_H // sc, GATE_W // sc), PLANE_Z,
                                                device=dev) for st, sc in scales},
             "mask": {f"stage{st}": torch.ones((1, GATE_H // sc, GATE_W // sc), device=dev)
                      for st, sc in scales}}
    model = build_train_model(cfg, dev)
    optimizer, scheduler = make_optimizer(model.parameters(), make_lr_schedule(1e-3, 1))
    step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode)
    cuda_build.reset_launches()
    t1 = time.perf_counter()
    for _ in range(GATE_STEPS):
        scalars, _ = step(model, optimizer, scheduler, batch)
    scalars = {k: float(v) for k, v in scalars.items()}
    overfit_s = time.perf_counter() - t1
    train_launches = cuda_build.launches()
    # the net must have learned the scene, or the bounds below would grade
    # fusion's rejection power instead of the chain
    if not scalars["thres4mm_error"] < 0.15:
        raise AssertionError(f"gate: {GATE_STEPS} steps left {scalars}")
    weights = os.path.join(tmp, "gate_weights.pt")
    ckpt_lib.save_weights(weights, model)

    cuda_build.reset_launches()
    summary = cli.main(argv + ["--resume", weights])
    test_launches = cuda_build.launches()
    if dev.type == "cuda":
        n = 6 * GATE_STEPS
        expect_launches("gate overfit", train_launches, warp_correlate=n,
                        warp_correlate_grad_ref=n, warp_correlate_grad_src=n)
        expect_launches("gate --test", test_launches,
                        warp_correlate=6 * run_test_forwards(GATE_V))
    xyz, _ = read_ply(summary["ply"][0])
    # GT "stl": a 2 mm grid on z = PLANE_Z over the region all views see
    gx, gy = np.meshgrid(np.arange(-150.0, 150.0, 2.0), np.arange(-120.0, 120.0, 2.0))
    stl = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, PLANE_Z)], axis=1)
    r = eval_scan(xyz.astype(np.float64), stl, scan_id=1)
    row = dict(points=len(xyz), mean_acc_mm=r.mean_acc, mean_comp_mm=r.mean_comp,
               overall_mm=r.overall, median_z_mm=float(np.median(xyz[:, 2])) if len(xyz) else None,
               steps=GATE_STEPS, thres4mm_error=scalars["thres4mm_error"], loss=scalars["loss"],
               train_launches=train_launches, test_launches=test_launches, maps=summary["maps"],
               num_worker=num_worker, overfit_s=overfit_s,
               fusion_s=summary["fusion_seconds"], seconds=time.perf_counter() - t0)
    if not (len(xyz) > 5000 and r.mean_acc < 4.0 and r.mean_comp < 4.0 and r.overall < 4.0
            and abs(row["median_z_mm"] - PLANE_Z) < 2.0):
        raise AssertionError(f"gate: {row}")
    return row, weights


def recipe_dtu(dev, tmp: str, weights: str) -> tuple[dict, str]:
    """Phase 12, the dtu_test recipe as users run it: the CLI's --test
    --preset dtu_test with the preset's own fusion (pcd, thres_view 5, conf
    0/0/0.3, num_view 5, eval_batch 2) on an 11-view synthetic scene at
    864x1152 (pair.txt lists 10 sources, as DTU's does), with the gate's
    weights loaded strictly (no parameter shape depends on ndepths).
    Returns the line and one depth PFM."""
    t0 = time.perf_counter()
    datapath, outdir = os.path.join(tmp, "recipe_dtu"), os.path.join(tmp, "recipe_dtu_out")
    synthetic.write_eval_scene(datapath, "scan1", height=H, width=W, n_views=RECIPE_V, seed=1)
    argv = ["--test", "--preset", "dtu_test", "--datapath", datapath, "--testlist", "scan1",
            "--outdir", outdir, "--resume", weights]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    got = (cfg.filter_method, cfg.thres_view, tuple(cfg.conf), cfg.num_view, cfg.eval_batch)
    if got != ("pcd", 5, (0.0, 0.0, 0.3), 5, 2):
        raise AssertionError(f"recipe_dtu: the preset gives {got}")
    cuda_build.reset_launches()
    summary = cli.main(argv)
    launches = cuda_build.launches()
    expect_launches("recipe_dtu", launches,
                    warp_correlate=6 * run_test_forwards(-(-RECIPE_V // cfg.eval_batch)))
    if summary["maps"] != RECIPE_V:
        raise AssertionError(f"recipe_dtu: {summary['maps']} maps")
    check_pfms(outdir, RECIPE_V)
    xyz, rgb = read_ply(summary["ply"][0])
    if not (np.isfinite(xyz).all() and xyz.shape == rgb.shape):
        raise AssertionError("recipe_dtu: the fused cloud has non-finite points")
    d = summary["dispatch_seconds"]
    return dict(maps=summary["maps"], launches=launches,
                ply=os.path.basename(summary["ply"][0]), points=len(xyz),
                median_z_mm=float(np.median(xyz[:, 2])) if len(xyz) else None,
                inference_s=sum(d), dispatch_s=d, fusion_s=summary["fusion_seconds"],
                seconds=time.perf_counter() - t0), os.path.join(outdir, "scan1", "depth_est",
                                                                "00000000.pfm")


def vis_phase(tmp: str, pfm: str) -> dict:
    """Phase 13: the CLI's --vis on one depth map of recipe_dtu; the PNG has
    the map's shape."""
    t0 = time.perf_counter()
    summary = cli.main(["--vis", "--depth_path", pfm, "--depth_img_save_dir",
                        os.path.join(tmp, "vis")])
    shape = np.asarray(Image.open(summary["png"])).shape
    if shape != (*io.read_pfm(pfm)[0].shape, 3):
        raise AssertionError(f"vis: {summary['png']} has shape {shape}")
    return dict(png=os.path.basename(summary["png"]), shape=list(shape),
                seconds=time.perf_counter() - t0)


def recipe_tank(dev, tmp: str, weights: str) -> dict:
    """Phase 14, the tank_test recipe at its full envelope: the CLI's --test
    --preset tank_test (11 views, ndepths 64/32/8, interval ratios 3/2/1,
    eval_batch 1, dypcd) on an 11-view wide-baseline scene (18 mm a view,
    as tools/tank_smoke.py) at 1080x2048, which snaps to 1056x2048, named
    outside TANK_SCENE_CONFIG, with --conf 0 0 0 so that dypcd's geometric
    test decides.  Peak device memory of the whole run; returns the line."""
    t0 = time.perf_counter()
    datapath, outdir = os.path.join(tmp, "recipe_tank"), os.path.join(tmp, "recipe_tank_out")
    synthetic.write_eval_scene(datapath, TANK_SCENE, height=TANK_H, width=TANK_W,
                               n_views=RECIPE_V, baseline=TANK_BASELINE, seed=2)
    scene_s = time.perf_counter() - t0
    if TANK_SCENE in TANK_SCENE_CONFIG:
        raise AssertionError(f"{TANK_SCENE} would take TANK_SCENE_CONFIG's overrides")
    argv = ["--test", "--preset", "tank_test", "--datapath", datapath, "--testlist",
            f"scans:{TANK_SCENE}", "--outdir", outdir, "--max_h", str(TANK_H),
            "--max_w", str(TANK_W), "--conf", "0", "0", "0", "--resume", weights]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    got = (cfg.filter_method, cfg.num_view, tuple(cfg.ndepths), tuple(cfg.interval_ratio),
           cfg.eval_batch)
    if got != ("dypcd", RECIPE_V, (64, 32, 8), (3, 2, 1), 1):
        raise AssertionError(f"recipe_tank: the preset gives {got}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    summary = cli.main(argv)
    launches = cuda_build.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    expect_launches("recipe_tank", launches, warp_correlate=6 * run_test_forwards(RECIPE_V))
    if summary["maps"] != RECIPE_V:
        raise AssertionError(f"recipe_tank: {summary['maps']} maps")
    for v in range(RECIPE_V):
        arr, _ = io.read_pfm(os.path.join(outdir, TANK_SCENE, "depth_est", f"{v:08d}.pfm"))
        if arr.shape != (TANK_SNAP_H, TANK_W) or not np.isfinite(arr).all():
            raise AssertionError(f"recipe_tank view {v}: shape {arr.shape}")
    xyz, _ = read_ply(summary["ply"][0])
    if not np.isfinite(xyz).all():
        raise AssertionError("recipe_tank: the fused cloud has non-finite points")
    d = summary["dispatch_seconds"]
    return dict(shape=[TANK_SNAP_H, TANK_W], views=RECIPE_V, ndepths=list(cfg.ndepths),
                filter_method=cfg.filter_method, maps=summary["maps"], launches=launches,
                peak_mem_gb=peak_gb, peak_reserved_gb=reserved_gb,
                card_mem_gb=torch.cuda.get_device_properties(0).total_memory / 1e9,
                dispatch_s=d, s_per_map_after_first=statistics.median(d[1:]),
                points=len(xyz), fusion_s=summary["fusion_seconds"], scene_s=scene_s,
                seconds=time.perf_counter() - t0)


def blendedmvs_path(dev, tmp: str, checkpoint: str) -> dict:
    """Phase 15: the blendedmvs_finetune recipe through the CLI on a
    synthetic BlendedMVS tree (576x768, 7 views, batch 1, numdepth 128,
    lr 1e-4), resuming the weights alone of phase 6's checkpoint: the
    weights equal the checkpoint's before the first step, epoch and step
    start at 0, BMVS_STEPS steps and one validation batch launch 6 forward
    + 6 + 6 adjoint kernels per step and 6 per validation batch, losses
    finite; ms per step (host clock around each synchronised step)."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "blendedmvs")
    synthetic.write_blendedmvs_tree(root, BMVS_SCENE, n_views=BMVS_V, height=BMVS_H,
                                    width=BMVS_W)
    argv = ["--preset", "blendedmvs_finetune", "--datapath", root,
            "--trainlist", f"scans:{BMVS_SCENE}", "--testlist", f"scans:{BMVS_SCENE}",
            "--log_dir", os.path.join(tmp, "bmvs_logs"), "--resume", checkpoint,
            "--epochs", "1", "--max_train_samples", str(BMVS_STEPS), "--max_val_samples", "1",
            "--summary_freq", "1"]
    want = torch.load(checkpoint, map_location="cpu", weights_only=True)["model"]
    seen, step_s, losses = {}, [], []
    original = Trainer.train

    def checked_train(self):
        got = self.model.state_dict()
        seen.update(weights_equal=set(got) == set(want)
                    and all(torch.equal(got[k].cpu(), want[k]) for k in want),
                    start_epoch=self.start_epoch, step=self.step,
                    dataset=type(self.train_ds).__name__, nviews=self.train_ds.nviews)
        step = self.train_step

        def timed_step(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scalars, out = step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(scalars["loss"]))
            return scalars, out

        self.train_step = timed_step
        return original(self)

    Trainer.train = checked_train
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    try:
        summary = cli.main(argv)
    finally:
        Trainer.train = original
    launches = cuda_build.launches()
    n = 6 * BMVS_STEPS
    expect_launches("blendedmvs", launches, warp_correlate=n + 6, warp_correlate_grad_ref=n,
                    warp_correlate_grad_src=n)
    epoch = summary["history"][0]
    if not (seen.get("weights_equal") and (seen["start_epoch"], seen["step"]) == (0, 0)
            and seen["dataset"] == "BlendedMVSDataset" and seen["nviews"] == BMVS_V
            and summary["step"] == BMVS_STEPS and len(losses) == BMVS_STEPS
            and all(np.isfinite(losses))
            and all(np.isfinite(v) for v in (*epoch["train_avg"].values(),
                                             *epoch["val_avg"].values()))):
        raise AssertionError(f"blendedmvs: resume {seen}, steps {summary['step']}, "
                             f"losses {losses}, {epoch}")
    return dict(steps=summary["step"], launches=launches, resumed=seen, losses=losses,
                val_avg=epoch["val_avg"], step_s=step_s,
                ms_per_step_after_first=1e3 * statistics.median(step_s[1:]),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                seconds=time.perf_counter() - t0)


# phases 19-22, the model options: the CLI flags of each bf16 policy;
# NUMERICS.json "tol" for bf16 maps against phase 5's fp32 maps; the bf16
# step's loss against the fp32 step; remat's running statistics against the
# step without remat
BF16_POLICIES = {"nets": ["--feature_dtype", "bfloat16", "--costreg_dtype", "bfloat16"],
                 "compute": ["--compute_dtype", "bfloat16"]}
BF16_TOL = dict(mean_mm=0.2, p99_mm=2.0, max_mm=10.0, conf_mean=0.005)
BF16_LOSS_RTOL, REMAT_STAT_RTOL = 1e-2, 1e-6


def map_diffs(out_dir: str, ref_dir: str) -> dict:
    """|depth| and |confidence| differences of the V maps of two runs."""
    def read(root, kind, v):
        return io.read_pfm(os.path.join(root, "scan1", kind, f"{v:08d}.pfm"))[0].astype(np.float64)

    d = np.stack([np.abs(read(out_dir, "depth_est", v) - read(ref_dir, "depth_est", v))
                  for v in range(V)])
    c = np.stack([np.abs(read(out_dir, "confidence", v) - read(ref_dir, "confidence", v))
                  for v in range(V)])
    return dict(depth_mean_mm=float(d.mean()), depth_p99_mm=float(np.percentile(d, 99)),
                depth_max_mm=float(d.max()), conf_mean=float(c.mean()), conf_max=float(c.max()))


def forward_timing(model, imgs, proj, dv) -> dict:
    """ms per map (median of 5 CUDA-event-timed batch-B forwards / B) and
    the peak device memory of one forward."""
    def forward():
        with torch.inference_mode():
            return model(imgs, proj, dv)

    ms = time_ms(forward, 5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    return dict(ms_per_map=ms / B, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def gated_phase(dev) -> list[dict]:
    """Phase 26: the gated adaptive pass on one tank_adaptive map.  The
    tank_test preset with agg_mode="adaptive" at 1056x1920, 11 views, batch
    1, seeded weights, one eval forward (6 gated launches, no kernel-1
    launch) whose gated passes are captured; per pass the kernel against its
    plain version, its time, and the per-pair route's time on the same
    inputs (kernel 1 on each pair and the model's own gate, ``MVSNet._gate``,
    as the route ran before the gated pass)."""
    cfg = preset("tank_test", agg_mode="adaptive", max_h=ADAPTIVE_H, max_w=ADAPTIVE_W,
                 filter_method="none")
    model = build_train_model(cfg, dev).eval()
    inputs = profiler.synthetic_inputs(cfg, 1, dev)
    captured = []
    cuda_build.reset_launches()
    with capture_calls(wc, "gated_warp_correlate", captured), torch.inference_mode():
        model(*inputs)
    torch.cuda.synchronize()
    launches = cuda_build.launches()
    expect_launches("gated forward", launches, gated_warp_correlate=6)
    if len(captured) != 6:
        raise AssertionError(f"captured {len(captured)} gated passes, expected 6")
    nets = [net for s in range(3) for net in (model.agg_weight[s], model.agg_weight_refine[s])]
    rows = []
    for name, net, (feats, rel, depth, gate) in zip(PASS_NAMES, nets, captured):
        b, v, h, w, c = feats.shape
        with torch.inference_mode():
            got = wc.gated_warp_correlate(feats, rel, depth, gate)
            want = wc.gated_warp_correlate_plain(feats, rel, depth, gate)
            torch.cuda.synchronize()
            err, tol = check_close(f"{name} (tank adaptive) gated pass", got, want)
            del got, want
            kernel_ms = time_ms(lambda: wc.gated_warp_correlate(feats, rel, depth, gate),
                                KERNEL_REPS, KERNEL_INNER)
            pairs_ms = time_ms(lambda: wc.adaptive_pairs(
                feats, rel, depth, lambda sim: model._gate(name, net, sim)), 5)
        nbytes, flops = pass_cost(b, v, depth.shape[1], h, w, c)
        row = bound(dict(pass_=name, kernel="gated_warp_correlate", inputs="model tank adaptive",
                         C=c, D=depth.shape[1], H=h, W=w, V=v, max_abs_err=err, tol=tol,
                         kernel_ms=kernel_ms, pairs_ms=pairs_ms, bytes=nbytes, flops=flops,
                         launches=1))
        print("gated " + json.dumps({k.rstrip("_"): x for k, x in row.items()}), flush=True)
        rows.append(row)
    return rows


def bf16_eval(dev, tmp: str) -> tuple[dict, list]:
    """Phase 19: the CLI's --test --preset dtu_test on phase 5's scene and
    seeded weights under each bf16 policy: launches, PFMs, depth and
    confidence against phase 5's fp32 maps (BF16_TOL), ms per map and peak
    memory beside the fp32 model's in this call; the tensors the first
    policy's six cost passes hand kernel 1 (fp32, upcast from bf16) for
    ``model_rows``."""
    out, captured = {}, []
    for name, flags in BF16_POLICIES.items():
        out_dir = os.path.join(tmp, f"out_{name}")
        argv = eval_argv(tmp) + flags + ["--outdir", out_dir]
        cuda_build.reset_launches()
        summary = cli.main(argv)
        torch.cuda.synchronize()
        launches = cuda_build.launches()
        expect_launches(f"bf16 eval ({name})", launches,
                        warp_correlate=6 * run_test_forwards(-(-V // B)))
        check_pfms(out_dir, V)
        diffs = map_diffs(out_dir, os.path.join(tmp, "out"))
        if not (diffs["depth_mean_mm"] <= BF16_TOL["mean_mm"]
                and diffs["depth_p99_mm"] <= BF16_TOL["p99_mm"]
                and diffs["depth_max_mm"] <= BF16_TOL["max_mm"]
                and diffs["conf_mean"] <= BF16_TOL["conf_mean"]):
            raise AssertionError(f"bf16 eval ({name}) against fp32: {diffs}, limits {BF16_TOL}")
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        model = build_model(cfg, dev)
        inputs = load_batch(cfg, dev)
        if not captured:
            with capture_calls(wc, "warp_correlate", captured), torch.inference_mode():
                model(*inputs)
            for feats, *_ in captured:
                if feats.dtype != torch.float32 or not torch.equal(feats, feats.bfloat16().float()):
                    raise AssertionError("kernel 1 did not receive bf16 features upcast to fp32")
        out[name] = dict(flags=flags, maps=summary["maps"], launches=launches, **diffs,
                         **forward_timing(model, *inputs))
        del model
    cfg = cli.config_from_args(cli.build_parser().parse_args(eval_argv(tmp)))
    out["fp32"] = forward_timing(build_model(cfg, dev), *load_batch(cfg, dev))
    out["policies_equal_maps"] = map_diffs(os.path.join(tmp, "out_nets"),
                                           os.path.join(tmp, "out_compute"))["depth_max_mm"] == 0
    return out, captured


def option_inputs(dev, tmp: str, checkpoint: str):
    """Phase 6's configuration, its weights (the checkpoint's) and one
    validation batch on the card, for phases 20-22."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(train_argv(tmp, "logs_options")))
    trainer = Trainer(cfg)
    batch = trainer.to_device(next(iter(trainer.val_loader)))
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)["model"]
    return cfg, sd, batch


def train_model(cfg, sd: dict, dev, **options):
    """The dtu_train MVSNet with ``options`` and the weights ``sd``; an
    adaptive model's weight nets keep their seeded init."""
    model = build_train_model(cfg.replace(**options), dev)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.startswith("agg_weight") for k in missing):
        raise AssertionError(f"weights: missing {missing}, unexpected {unexpected}")
    return model


def step_grads(model, cfg, batch, impl: str = "cuda") -> dict:
    """One forward, loss and backward of ``model`` in train mode under
    deterministic cuDNN (``impl`` "torch": the plain cost passes): loss,
    gradients and new running statistics on the host, launches, and the
    feature tensors the cost passes received with their gradients' dtype."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    seen, hooked_ids = [], set()
    real = wc.aggregate_cost_volume

    def hooked(feats, *args):
        # once per tensor: remat's recompute hands the same features again
        if feats.requires_grad and id(feats) not in hooked_ids:
            hooked_ids.add(id(feats))
            feats.register_hook(lambda g: seen.append(
                (str(feats.dtype), str(g.dtype), bool(torch.isfinite(g.float()).all()))))
        return real(feats, *args)

    wc.aggregate_cost_volume = hooked
    try:
        model.warp_impl = impl
        model.train()
        model.zero_grad(set_to_none=True)
        cuda_build.reset_launches()
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss = mvs_loss(out, batch["depth"], batch["mask"], cfg.depth_mode, tuple(cfg.dlossw))
        loss.backward()
        torch.cuda.synchronize()
        launches = cuda_build.launches()
    finally:
        wc.aggregate_cost_volume = real
        torch.backends.cudnn.deterministic = saved
        model.warp_impl = "cuda"
    return dict(loss=loss.item(), launches=launches, feats=seen,
                grads={n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters()},
                state={k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
                       if ".running_" in k or k.endswith("num_batches_tracked")})


def step_timing(model, cfg, batch, n: int = 3) -> dict:
    """ms per train step (median of ``n`` CUDA-event-timed steps after one
    untimed, Adam at learning rate 0 so the weights stay) and the peak
    device memory of those steps."""
    optimizer, scheduler = make_optimizer(model.parameters(), lambda i: 0.0)
    step = make_train_step(tuple(cfg.dlossw), cfg.depth_mode)
    step(model, optimizer, scheduler, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    events = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(model, optimizer, scheduler, batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return dict(ms_per_step=statistics.median(s.elapsed_time(e) for s, e in events),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def bf16_train(dev, inputs, yardstick: dict) -> dict:
    """Phase 20: one dtu_train step at compute_dtype=bfloat16 from phase 6's
    weights against the fp32 step: loss (BF16_LOSS_RTOL), gradients as
    relative L2 differences beside phase 6's yardstick, the six cost
    passes' features bf16 with bf16, finite gradients, kernels 1-3 launched
    six times each; ms per step and peak memory."""
    cfg, sd, batch = inputs
    fp32 = step_grads(train_model(cfg, sd, dev), cfg, batch)
    model = train_model(cfg, sd, dev, compute_dtype="bfloat16")
    bf = step_grads(model, cfg, batch)
    expect_launches("bf16 train step", bf["launches"], warp_correlate=6,
                    warp_correlate_grad_ref=6, warp_correlate_grad_src=6)
    if len(bf["feats"]) != 6 or any(f != ("torch.bfloat16", "torch.bfloat16", True)
                                    for f in bf["feats"]):
        raise AssertionError(f"bf16 step: feature tensors and gradients {bf['feats']}")
    rel = abs(bf["loss"] - fp32["loss"]) / abs(fp32["loss"])
    if not (np.isfinite(bf["loss"]) and rel <= BF16_LOSS_RTOL):
        raise AssertionError(f"bf16 step loss {bf['loss']} against fp32 {fp32['loss']}")
    return dict(loss_fp32=fp32["loss"], loss_bf16=bf["loss"], loss_rel_diff=rel,
                grad_rel_l2_diff_vs_fp32=grad_diff(bf["grads"], fp32["grads"]),
                phase6_yardstick=yardstick, launches=bf["launches"],
                feature_grads=sorted(set(bf["feats"])), **step_timing(model, cfg, batch))


def remat_phase(dev, inputs) -> dict:
    """Phase 21: the step with remat=True against remat=False under
    deterministic cuDNN, from the same weights: loss (LOSS_RTOL), gradients
    (PATH_GRAD_RTOL: kernel 2's atomic sums differ from run to run),
    running statistics (REMAT_STAT_RTOL * max(1, |stat|)), each updated
    once; kernel 1 launched 6 times in the forward and 6 more in the
    recompute; ms per step and peak memory of both."""
    cfg, sd, batch = inputs
    runs = {}
    for remat in (False, True):
        model = train_model(cfg, sd, dev, remat=remat)
        held = step_grads(model, cfg, batch)
        expect_launches(f"remat={remat} step", held["launches"],
                        warp_correlate=12 if remat else 6, warp_correlate_grad_ref=6,
                        warp_correlate_grad_src=6)
        runs[remat] = dict(held, **step_timing(model, cfg, batch))
        del model
    off, on = runs[False], runs[True]
    stat_err = max((on["state"][k].double() - v.double()).abs().max().item()
                   / max(1.0, v.abs().max().item())
                   for k, v in off["state"].items() if ".running_" in k)
    tracked = {k: int(on["state"][k]) - int(sd[k]) for k in off["state"]
               if k.endswith("num_batches_tracked")}
    loss_rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    grads = grad_diff(on["grads"], off["grads"])
    if not (loss_rel <= LOSS_RTOL and stat_err <= REMAT_STAT_RTOL
            and set(tracked.values()) == {1} and np.isfinite(on["loss"])
            and all(np.isfinite(grads[k]) and grads[k] <= t for k, t in PATH_GRAD_RTOL.items())):
        raise AssertionError(f"remat against no remat: loss {loss_rel}, gradients {grads}, "
                             f"statistics {stat_err}, updates {set(tracked.values())}")
    return dict(loss=off["loss"], loss_remat=on["loss"], loss_rel_diff=loss_rel,
                grad_rel_l2_diff=grads, stat_rel_diff=stat_err,
                stat_updates=sorted(set(tracked.values())),
                launches={"remat": on["launches"], "no_remat": off["launches"]},
                ms_per_step=on["ms_per_step"], peak_mem_gb=on["peak_mem_gb"],
                no_remat_ms_per_step=off["ms_per_step"], no_remat_peak_mem_gb=off["peak_mem_gb"])


def adaptive_phase(dev, tmp: str, inputs, yardstick: dict) -> dict:
    """Phase 22, agg_mode="adaptive": the CLI's dtu_test on phase 5's scene
    with seeded weights (a gated-pass launch per pass and dispatch, V-1
    kernel-1 launches per pass in the counted forward); one batch of that
    model on the kernel path against the plain path (depth 0.05 mm,
    confidence 1e-3) and its ms per map; one dtu_train step from phase 6's
    weights with seeded weight nets, kernel path against plain path
    (LOSS_RTOL, PATH_GRAD_RTOL over all parameters and for the median; each
    parameter within the worst-parameter bound or 10x this model's own
    yardstick for it, below), V-1 launches of each kernel per pass, and its
    ms per step."""
    out_dir = os.path.join(tmp, "out_adaptive")
    argv = eval_argv(tmp) + ["--agg_mode", "adaptive", "--outdir", out_dir]
    per_pass = V - 1
    cuda_build.reset_launches()
    summary = cli.main(argv)
    torch.cuda.synchronize()
    cli_launches = cuda_build.launches()
    # the dispatches take the gated pass; the counted summary forward runs
    # pair by pair (no fold under the cost count)
    dispatches = -(-V // B)
    expect_launches("adaptive eval", cli_launches, gated_warp_correlate=6 * dispatches,
                    warp_correlate=6 * per_pass * (run_test_forwards(dispatches) - dispatches))
    check_pfms(out_dir, V)
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    model = build_model(cfg, dev)
    imgs, proj, dv = load_batch(cfg, dev)

    def forward(impl):
        model.warp_impl = impl
        with torch.inference_mode():
            return model(imgs, proj, dv)

    out_p = forward("torch")
    cuda_build.reset_launches()
    out_k = forward("cuda")
    torch.cuda.synchronize()
    expect_launches("adaptive forward", cuda_build.launches(), gated_warp_correlate=6)
    d_err = (out_k["depth"] - out_p["depth"]).abs().max().item()
    c_err = (out_k["photometric_confidence"] - out_p["photometric_confidence"]).abs().max().item()
    if not (d_err <= 0.05 and c_err <= 1e-3 and bool(torch.isfinite(out_k["depth"]).all())):
        raise AssertionError(f"adaptive kernel vs plain model: depth {d_err} mm, conf {c_err}")
    timing = forward_timing(model, imgs, proj, dv)
    del model, out_k, out_p

    tcfg, sd, batch = inputs
    model = train_model(tcfg, sd, dev, agg_mode="adaptive")
    k = step_grads(model, tcfg, batch)
    expect_launches("adaptive step", k["launches"], warp_correlate=6 * per_pass,
                    warp_correlate_grad_ref=6 * per_pass, warp_correlate_grad_src=6 * per_pass)
    p = step_grads(model, tcfg, batch, impl="torch")
    with ulp_noise_on_plain_cost_volumes():
        y = step_grads(model, tcfg, batch, impl="torch")
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    paths = grad_diff(k["grads"], p["grads"])
    # The weight nets are scale-free where a train-mode batch norm follows:
    # the second convolution is one weight (1 -> 1 channel) whose scale the
    # next batch norm undoes but for eps, and the first batch norm's scale
    # cancels against its shift behind the ReLU.  Their gradients are
    # residues of cancelling terms (at 64x96 on the CPU -1.9e-4 for a second
    # convolution where the first one's are -57 and -23), so their relative
    # differences between two paths are noise over noise.  Each parameter is
    # therefore held to the worst-parameter bound or to 10x what half an
    # ulp of noise on the plain path's cost volumes does to it (this model's
    # own yardstick), whichever is larger; the bounds over all parameters
    # and the median hold as they are.
    def rel(grads, n):
        return (grads[n] - p["grads"][n]).norm().item() / max(p["grads"][n].norm().item(), 1e-30)

    own_yardstick = grad_diff(y["grads"], p["grads"])
    worst = PATH_GRAD_RTOL["worst_parameter"]
    per_param = {n: (rel(k["grads"], n), rel(y["grads"], n)) for n in p["grads"]}
    beyond = {n: dict(paths=a, yardstick=b) for n, (a, b) in per_param.items() if a > worst}
    if not (np.isfinite(k["loss"]) and loss_rel <= LOSS_RTOL
            and all(np.isfinite(paths[n]) and paths[n] <= PATH_GRAD_RTOL[n]
                    for n in ("all_parameters", "median_parameter"))
            and all(np.isfinite(a) and a <= max(worst, 10 * b) for a, b in per_param.values())):
        raise AssertionError(f"adaptive kernel vs plain step: loss {loss_rel}, gradients {paths}, "
                             f"beyond {worst}: {beyond}, yardstick {own_yardstick}")
    return dict(maps=summary["maps"], cli_launches=cli_launches,
                depth_max_abs_diff_mm=d_err, conf_max_abs_diff=c_err,
                ms_per_map=timing["ms_per_map"], eval_peak_mem_gb=timing["peak_mem_gb"],
                step_launches=k["launches"], loss_kernel=k["loss"], loss_plain=p["loss"],
                loss_rel_diff=loss_rel, grad_rel_l2_diff_paths=paths,
                beyond_worst_bound=beyond, yardstick=own_yardstick, phase6_yardstick=yardstick,
                **step_timing(model, tcfg, batch))


@contextlib.contextmanager
def counting_all_reduce():
    """What the port all-reduced within the block (batch norm, loss counts,
    metrics, the vp cost sum, the sp halo exchanges and gathers), from
    ``parallel.mesh.all_reduces``: calls and bytes, filled into the yielded
    dict at the block's end, and per kind under "by_label": the ``label``
    of the ``parallel.mesh.psum`` that issued it, forward or backward
    ("halo", "gather", "batch_norm", "view_sum"), "other" for the
    unlabelled ones (the loss's and the metrics' sums).  DDP's gradient
    all_reduce runs in C++ and is counted apart (its bytes are the
    parameters')."""
    seen = {"calls": 0, "bytes": 0, "by_label": {}}
    before = mesh_lib.all_reduces()
    try:
        yield seen
    finally:
        zero = {"calls": 0, "bytes": 0}
        for label, counts in mesh_lib.all_reduces().items():
            kind = {k: v - before.get(label, zero)[k] for k, v in counts.items()}
            if kind["calls"]:
                seen["by_label"][label] = kind
                seen["calls"] += kind["calls"]
                seen["bytes"] += kind["bytes"]


def held_step(net, model, step, optimizer, scheduler, batch) -> dict:
    """One train step under deterministic cuDNN (the comparisons of phase 6
    need it): global scalars, launches, gradients and new running statistics
    (on the host), what the port all-reduced."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cuda_build.reset_launches()
        with counting_all_reduce() as reduced:
            scalars, _ = step(net, optimizer, scheduler, batch)
            torch.cuda.synchronize()
        launches = cuda_build.launches()
    finally:
        torch.backends.cudnn.deterministic = saved
    return dict(scalars={k: float(v) for k, v in scalars.items()}, launches=launches,
                grads={n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters()},
                stats={k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
                       if ".running_" in k},
                all_reduce=dict(port_calls=reduced["calls"], port_bytes=reduced["bytes"],
                                by_label=reduced["by_label"], ddp_gradient_bytes=sum(p.numel() * p.element_size()
                                                       for p in model.parameters())))


def step_ms(net, step, optimizer, scheduler, batch, n: int = 3) -> float:
    """Median host-clock ms of ``n`` synchronised train steps, every rank
    starting each step together (``synced_ms``)."""
    return synced_ms(lambda: step(net, optimizer, scheduler, batch), n)


def synced_ms(fn, n: int = 3) -> float:
    """Median host-clock ms of ``n`` synchronised calls of ``fn``, every
    rank starting each call together (the ranks' collectives wait on each
    other, so CUDA events of one rank would not time the call)."""
    times = []
    for _ in range(n):
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def run_ranks(args: list[str], n: int, timeout_s: float = RANKS_TIMEOUT_S) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node n
    *args`` from the repository root, in a session of its own: every process
    of it is killed at the time limit, and a rank that fails or times out
    raises.  Returns the output."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        raise AssertionError(f"{n} rank(s) of {args[:4]} did not finish in {timeout_s} s:\n"
                             f"{out[-6000:]}") from None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{n} rank(s) of {args[:4]} exited {proc.returncode}:\n{out[-6000:]}")
    return out


def rank_worker(task: str, task_dir: str) -> None:
    """A rank of phase 16 ("cli": cli.main under torchrun, nccl), of phases
    17-18 ("gloo": the dp step, the vp forward and the vp step, two ranks on
    the one card over gloo), of phase 23 ("sp", "dpsp": ``sp_rank``) or of
    phase 25 ("spfold": ``sp_forward`` under the folded plan).
    Writes its results to task_dir."""
    with open(os.path.join(task_dir, "task.json")) as f:
        spec = json.load(f)
    pin_fp32()
    if task == "cli":
        cuda_build.reset_launches()
        summary = cli.main(spec["argv"])
        out = dict(summary=summary, launches=cuda_build.launches(), backend=dist.get_backend(),
                   world=dist.get_world_size(), device=torch.cuda.get_device_name(0))
        with open(os.path.join(task_dir, f"rank{dist.get_rank()}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
        return
    os.environ["LOCAL_RANK"] = "0"  # every rank computes on the one card
    info = init_multihost("cuda", backend="gloo", timeout_s=RANKS_TIMEOUT_S)
    rank = info["process_index"]
    out = dict(init=info, backend=dist.get_backend())
    if task in ("sp", "dpsp", "spfold"):
        out.update(sp_rank(task, spec, task_dir, rank) if task != "spfold"
                   else {"forward": sp_forward(spec, resolve_device())})
        torch.save(out, os.path.join(task_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        return

    # phase 17: the dp Trainer (one element per rank) resuming phase 6
    t0 = time.perf_counter()
    train_cfg = cli.config_from_args(cli.build_parser().parse_args(spec["train_argv"]))
    trainer = Trainer(train_cfg.replace(resume=spec["checkpoint"],
                                        log_dir=os.path.join(task_dir, "logs")))
    if not (isinstance(trainer.net, DistributedDataParallel) and trainer.device.type == "cuda"
            and trainer.mesh.shape["dp"] == GLOO_RANKS and trainer.model.warp_impl == "cuda"):
        raise AssertionError(f"dp trainer: {type(trainer.net)} on {trainer.device}, "
                             f"mesh {trainer.mesh.shape}, {trainer.model.warp_impl}")
    batch = trainer.to_device(next(iter(trainer.val_loader)))
    args = (trainer.net, trainer.train_step, trainer.optimizer, trainer.scheduler, batch)
    out["dp"] = held_step(trainer.net, trainer.model, *args[1:])
    out["dp"]["ms_per_step"] = step_ms(*args)
    out["dp"]["seconds"] = time.perf_counter() - t0
    val_ds, dev = trainer.val_ds, trainer.device
    del trainer, batch, args
    torch.cuda.empty_cache()

    # phase 18: the dtu_test forward with two source views per rank ...
    t0 = time.perf_counter()
    mesh = make_mesh(n_data=1, n_view=GLOO_RANKS, device=dev)
    test_cfg = cli.config_from_args(cli.build_parser().parse_args(spec["test_argv"]))
    model = replicate_tree(build_train_model(test_cfg, dev, mesh).eval())
    imgs, proj, dv = load_batch(test_cfg, dev)
    captured = []
    cuda_build.reset_launches()
    with (capture_calls(wc, "warp_correlate", captured, to="cpu") if rank == 0
          else contextlib.nullcontext()), torch.inference_mode():
        o = model(imgs, proj, dv)
    torch.cuda.synchronize()
    out["vp_forward"] = dict(launches=cuda_build.launches(), depth=o["depth"].cpu(),
                             conf=o["photometric_confidence"].cpu(),
                             views_per_launch=[c[0].shape[1] for c in captured])
    if rank == 0:
        torch.save(captured, os.path.join(task_dir, "vp_passes.pt"))
    del captured, o

    def forward():
        with torch.inference_mode():
            model(imgs, proj, dv)

    out["vp_forward"]["ms_per_forward"] = time_ms(forward, 3)
    out["vp_forward"]["seconds"] = time.perf_counter() - t0
    del model, imgs, proj, dv
    torch.cuda.empty_cache()

    # ... and one dtu_train step on the joined batch, two source views per rank
    t0 = time.perf_counter()
    model = build_train_model(train_cfg, dev, mesh)
    ckpt_lib.restore_weights(spec["checkpoint"], model)
    net = data_parallel(model)
    optimizer, scheduler = make_optimizer(model.parameters(), lambda n: 0.0)
    step = make_train_step(tuple(train_cfg.dlossw), train_cfg.depth_mode, mesh)
    joined = next(iter(make_loader(val_ds, B, "val")))
    joined = shard_batch({k: v for k, v in joined.items() if k != "filename"}, mesh)
    out["vp_step"] = held_step(net, model, step, optimizer, scheduler, joined)
    out["vp_step"]["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(task_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dp_nccl(tmp: str, argv: list[str], checkpoint: str) -> dict:
    """Phase 16: the training CLI under torchrun at world size 1 (nccl):
    cli.main in the rank, on phase 6's tree (3 steps, a validation batch, a
    checkpoint: 6 + 6 + 6 launches per step), then the CLI as users launch
    it, ``torchrun ... -m dmvsnet_tpu_torch.cli --resume``, for one more
    epoch of one step.  Both checkpoints carry the reference names of
    phase 6's."""
    t0 = time.perf_counter()
    before = host_and_card()
    d = os.path.join(tmp, "dp_nccl")
    os.makedirs(d)
    with open(os.path.join(d, "task.json"), "w") as f:
        json.dump(dict(argv=argv), f)
    run_ranks(["chip_smoke.py", "--rank-task", "cli", "--task-dir", d], 1)
    with open(os.path.join(d, "rank0.json")) as f:
        r = json.load(f)
    steps = 3
    expect_launches("dp nccl", r["launches"], warp_correlate=6 * (steps + 1),
                    warp_correlate_grad_ref=6 * steps, warp_correlate_grad_src=6 * steps)
    epoch = r["summary"]["history"][0]
    if (r["backend"], r["world"], r["summary"]["step"]) != ("nccl", 1, steps) or not all(
            np.isfinite(v) for v in (*epoch["train_avg"].values(), *epoch["val_avg"].values())):
        raise AssertionError(f"dp nccl: {r}")
    names = set(torch.load(checkpoint, map_location="cpu", weights_only=True)["model"])
    first = torch.load(epoch["checkpoint"], map_location="cpu", weights_only=True)
    t1 = time.perf_counter()
    run_ranks(["-m", "dmvsnet_tpu_torch.cli", *argv, "--resume", epoch["checkpoint"],
               "--max_train_samples", "2"], 1)
    resume_s = time.perf_counter() - t1
    second = torch.load(os.path.join(os.path.dirname(epoch["checkpoint"]), "model_000001.ckpt"),
                        map_location="cpu", weights_only=True)
    if not (set(first["model"]) == set(second["model"]) == names
            and (first["epoch"], first["step"], second["epoch"], second["step"])
            == (0, steps, 1, steps + 1)):
        raise AssertionError(f"dp nccl checkpoints: epochs {first['epoch']}, {second['epoch']}, "
                             f"steps {first['step']}, {second['step']}, reference names "
                             f"{set(first['model']) == names}")
    return dict(backend=r["backend"], world=r["world"], steps=r["summary"]["step"],
                launches=r["launches"], train_avg=epoch["train_avg"], val_avg=epoch["val_avg"],
                resumed_epoch=second["epoch"], resumed_step=second["step"],
                resume_run_s=resume_s, before=before, seconds=time.perf_counter() - t0)


def gloo_ranks(dev, tmp: str, train_argv: list[str], test_argv: list[str],
               checkpoint: str, yardstick: dict, one_process_ms: float) -> tuple[dict, dict, list]:
    """Phases 17 and 18: two ranks on the one card over gloo, held against
    one process on the same inputs.  17, "dp": the Trainer at dtu_train on a
    dp mesh, resuming phase 6's checkpoint, one element of the validation
    batch per rank; one step under deterministic cuDNN: loss and gradients
    against the one-process step on the joined batch (phase 6's bounds,
    beside its half-ulp yardstick), running statistics, scalars identical on
    both ranks, 6 + 6 + 6 launches per rank.  18, "vp": the dtu_test forward
    at 864x1152 (batch 2, two source views per rank) against the
    one-process model (depth 0.05 mm, confidence 1e-3), 6 kernel-1 launches
    per rank over 3 views each; then one vp train step at dtu_train, held
    as the dp step.  ``yardstick`` and ``one_process_ms`` (ms per step of
    one process at batch 2) are phase 6's, printed beside.  Returns the two
    lines and rank 0's six vp passes."""
    train_cfg = cli.config_from_args(cli.build_parser().parse_args(train_argv))
    ref_trainer = Trainer(train_cfg.replace(resume=checkpoint))
    batch = ref_trainer.to_device(next(iter(ref_trainer.val_loader)))
    ref = held_step(ref_trainer.net, ref_trainer.model, ref_trainer.train_step,
                    ref_trainer.optimizer, ref_trainer.scheduler, batch)
    del ref_trainer, batch
    test_cfg = cli.config_from_args(cli.build_parser().parse_args(test_argv))
    model = build_model(test_cfg, dev)
    imgs, proj, dv = load_batch(test_cfg, dev)
    with torch.inference_mode():
        o = model(imgs, proj, dv)
    ref_depth, ref_conf = o["depth"].cpu(), o["photometric_confidence"].cpu()
    del model, imgs, proj, dv, o
    torch.cuda.empty_cache()

    d = os.path.join(tmp, "gloo_ranks")
    os.makedirs(d)
    with open(os.path.join(d, "task.json"), "w") as f:
        json.dump(dict(train_argv=train_argv, test_argv=test_argv, checkpoint=checkpoint), f)
    before = host_and_card()
    t0 = time.perf_counter()
    run_ranks(["chip_smoke.py", "--rank-task", "gloo", "--task-dir", d], GLOO_RANKS)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(GLOO_RANKS)]
    per_step = dict(warp_correlate=6, warp_correlate_grad_ref=6, warp_correlate_grad_src=6)

    def held(what: str) -> dict:
        r0, r1 = (r[what] for r in ranks)
        for i, r in enumerate(ranks):
            expect_launches(f"{what} rank {i}", r[what]["launches"], **per_step)
        loss = abs(r0["scalars"]["loss"] - ref["scalars"]["loss"]) / abs(ref["scalars"]["loss"])
        grads = grad_diff(r0["grads"], ref["grads"])
        stats = max(float((r[what]["stats"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                    for r in ranks for k, v in ref["stats"].items())
        same = r0["scalars"] == r1["scalars"] and all(
            torch.equal(g, r1["grads"][n]) for n, g in r0["grads"].items())
        row = dict(loss=r0["scalars"]["loss"], loss_one_process=ref["scalars"]["loss"],
                   loss_rel_diff=loss, grad_rel_l2_diff=grads,
                   grad_rel_l2_diff_yardstick_phase_6=yardstick, stats_rel_diff=stats,
                   scalars_and_grads_identical_on_ranks=same,
                   launches_per_rank=[r[what]["launches"] for r in ranks],
                   all_reduce_per_step=r0["all_reduce"], seconds=r0["seconds"])
        if not (np.isfinite(r0["scalars"]["loss"]) and loss <= LOSS_RTOL and same
                and stats <= STAT_RTOL
                and all(grads[k] <= tol for k, tol in PATH_GRAD_RTOL.items())):
            raise AssertionError(f"{what} against one process: {row}")
        return row

    dp = held("dp")
    dp.update(ms_per_step_2_ranks_sharing_one_card_over_gloo=[r["dp"]["ms_per_step"]
                                                               for r in ranks],
              ms_per_step_one_process_phase_6=one_process_ms)
    fwd = [r["vp_forward"] for r in ranks]
    d_err = max(float((f["depth"] - ref_depth).abs().max()) for f in fwd)
    c_err = max(float((f["conf"] - ref_conf).abs().max()) for f in fwd)
    for i, f in enumerate(fwd):
        expect_launches(f"vp forward rank {i}", f["launches"], warp_correlate=6)
    if not (d_err <= 0.05 and c_err <= 1e-3 and fwd[0]["views_per_launch"] == [3] * 6):
        raise AssertionError(f"vp forward: depth {d_err} mm, conf {c_err}, views per launch "
                             f"{fwd[0]['views_per_launch']}")
    vp = dict(forward=dict(depth_max_abs_diff_mm=d_err, conf_max_abs_diff=c_err,
                           launches_per_rank=[f["launches"] for f in fwd],
                           views_per_launch=fwd[0]["views_per_launch"],
                           ms_per_forward_2_ranks_sharing_one_card_over_gloo=[
                               f["ms_per_forward"] for f in fwd],
                           seconds=fwd[0]["seconds"]),
              step=held("vp_step"))
    return (dict(init=[r["init"] for r in ranks], backend=ranks[0]["backend"],
                 ranks_run_s=ranks_s, before=before, **dp), vp,
            torch.load(os.path.join(d, "vp_passes.pt"), weights_only=False))


def sp_forward(spec: dict, dev) -> dict:
    """The dtu_test forward of a rank on phase 5's scene and weights with
    the rows split over sp = 2 (with the plan ``spec["fold_level0"]``, None
    where absent): launches, maps on the host, unsplit passes, folded
    convolutions, peak memory, all_reduce calls and bytes, synced ms."""
    t0 = time.perf_counter()
    mesh = make_mesh(n_data=1, n_spatial=2, device=dev)
    test_cfg = cli.config_from_args(cli.build_parser().parse_args(spec["test_argv"]))
    model = replicate_tree(build_train_model(test_cfg, dev, mesh).eval())
    model.fold_level0 = spec.get("fold_level0")
    imgs, proj, dv = load_batch(test_cfg, dev)

    def forward():
        with torch.inference_mode():
            return model(imgs, proj, dv)

    cuda_build.reset_launches()
    spatial.stats["unsplit_passes"] = 0
    before = dict(folded.stats)
    torch.cuda.reset_peak_memory_stats()
    with counting_all_reduce() as reduced:
        o = forward()
        torch.cuda.synchronize()
    out = dict(launches=cuda_build.launches(), depth=o["depth"].cpu(),
               conf=o["photometric_confidence"].cpu(),
               unsplit_passes=spatial.stats["unsplit_passes"],
               folded={k: v - before[k] for k, v in folded.stats.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               all_reduce=dict(calls=reduced["calls"], bytes=reduced["bytes"],
                               by_label=reduced["by_label"]))
    del o
    out["ms_per_forward"] = synced_ms(forward)
    out["seconds"] = time.perf_counter() - t0
    return out


def sp_rank(task: str, spec: dict, task_dir: str, rank: int) -> dict:
    """A rank of phase 23 on the one card over gloo.  "sp" (2 ranks): the
    dtu_test forward on phase 5's scene and weights with the rows split over
    sp = 2; the Trainer at dtu_train with --mesh_spatial 2 resuming phase 6's
    checkpoint, one step on the whole validation batch; then cli.main with
    --mesh_spatial 2 for one step, a validation batch and a checkpoint.
    "dpsp" (4 ranks): the same Trainer step on a 2 dp x 2 sp mesh."""
    dev = resolve_device()
    out = {}
    train_cfg = cli.config_from_args(cli.build_parser().parse_args(spec["train_argv"]))
    if task == "sp":
        out["forward"] = sp_forward(spec, dev)
        torch.cuda.empty_cache()
        meshes = dict(mesh_spatial=2)
    else:
        meshes = dict(mesh_data=2, mesh_spatial=2)

    t0 = time.perf_counter()
    trainer = Trainer(train_cfg.replace(resume=spec["checkpoint"], **meshes,
                                        log_dir=os.path.join(task_dir, "logs")))
    want = {"dp": meshes.get("mesh_data", 1), "vp": 1, "sp": 2}
    if not (isinstance(trainer.net, DistributedDataParallel) and trainer.device == dev
            and trainer.mesh.shape == want and trainer.model.warp_impl == "cuda"):
        raise AssertionError(f"{task} trainer: {type(trainer.net)} on {trainer.device}, "
                             f"mesh {trainer.mesh.shape}, {trainer.model.warp_impl}")
    host = next(iter(trainer.val_loader))
    batch = trainer.to_device(host)
    args = (trainer.net, trainer.train_step, trainer.optimizer, trainer.scheduler, batch)
    torch.cuda.reset_peak_memory_stats()
    step = held_step(trainer.net, trainer.model, *args[1:])
    step["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    step["per_rank_batch"] = int(host["imgs"].shape[0])
    step["first_view"] = torch.from_numpy(host["imgs"][:, 0])
    step["ms_per_step"] = step_ms(*args)
    step["seconds"] = time.perf_counter() - t0
    out["step"] = step
    del trainer, batch, args
    torch.cuda.empty_cache()

    if task == "sp":
        # the training CLI with --mesh_spatial 2 in this rank (the group
        # exists, so cli.main's init_multihost leaves it as it is)
        t0 = time.perf_counter()
        cuda_build.reset_launches()
        summary = cli.main([*spec["cli_argv"], "--mesh_spatial", "2"])
        out["cli"] = dict(launches=cuda_build.launches(), step=summary["step"],
                          history=summary["history"], seconds=time.perf_counter() - t0)
    return out


def sp_phase(dev, tmp: str, train_argv: list[str], test_argv: list[str], cli_argv: list[str],
             checkpoint: str, yardstick: dict, one_process_ms: float) -> dict:
    """Phase 23, "sp": ranks on the one card over gloo, each running the
    cost U-Nets on its band of rows, held against one process on the same
    inputs.  sp = 2 eval: the dtu_test forward at 864x1152 (batch 2, phase
    5's weights) against the one-process forward (depth 0.05 mm, confidence
    1e-3; mean / p99 / max printed beside NUMERICS.json "tol"), 6 kernel-1
    launches per rank on the whole image, no unsplit pass.  sp = 2 and
    dp 2 x sp 2 train: one dtu_train step from phase 6's checkpoint on its
    validation batch under deterministic cuDNN against the one-process step
    (LOSS_RTOL, PATH_GRAD_RTOL beside phase 6's yardstick, STAT_RTOL),
    scalars and gradients identical on every rank, 6 + 6 + 6 launches per
    rank, the sp ranks of a dp coordinate on the same samples.  The CLI:
    one step with --mesh_spatial 2 in each of the 2 ranks.  Per-rank peaks
    beside the one-process peaks; all_reduce calls and bytes per kind; ms
    of ranks time-sharing the card."""
    t_total = time.perf_counter()
    # one-process peaks above what this process held before (a rank starts
    # with nothing on the card)
    held_before = torch.cuda.memory_allocated()
    train_cfg = cli.config_from_args(cli.build_parser().parse_args(train_argv))
    ref_trainer = Trainer(train_cfg.replace(resume=checkpoint))
    batch = ref_trainer.to_device(next(iter(ref_trainer.val_loader)))
    torch.cuda.reset_peak_memory_stats()
    ref = held_step(ref_trainer.net, ref_trainer.model, ref_trainer.train_step,
                    ref_trainer.optimizer, ref_trainer.scheduler, batch)
    ref_train_peak = (torch.cuda.max_memory_allocated() - held_before) / 1e9
    del ref_trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    test_cfg = cli.config_from_args(cli.build_parser().parse_args(test_argv))
    held_before_eval = torch.cuda.memory_allocated()
    model = build_model(test_cfg, dev)
    imgs, proj, dv = load_batch(test_cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        o = model(imgs, proj, dv)
    torch.cuda.synchronize()
    ref_eval_peak = (torch.cuda.max_memory_allocated() - held_before_eval) / 1e9
    ref_depth, ref_conf = o["depth"].cpu(), o["photometric_confidence"].cpu()
    del model, imgs, proj, dv, o
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for task, n in (("sp", 2), ("dpsp", 4)):
        d = os.path.join(tmp, f"sp_{task}")
        os.makedirs(d)
        with open(os.path.join(d, "task.json"), "w") as f:
            json.dump(dict(train_argv=train_argv, test_argv=test_argv, cli_argv=cli_argv,
                           checkpoint=checkpoint), f)
        before = host_and_card()
        t0 = time.perf_counter()
        run_ranks(["chip_smoke.py", "--rank-task", task, "--task-dir", d], n)
        runs[task] = dict(ranks=[torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                                 for r in range(n)],
                          seconds=time.perf_counter() - t0, before=before)
    per_step = dict(warp_correlate=6, warp_correlate_grad_ref=6, warp_correlate_grad_src=6)

    def held(task: str) -> dict:
        ranks = [r["step"] for r in runs[task]["ranks"]]
        r0 = ranks[0]
        for i, r in enumerate(ranks):
            expect_launches(f"{task} step rank {i}", r["launches"], **per_step)
        loss = abs(r0["scalars"]["loss"] - ref["scalars"]["loss"]) / abs(ref["scalars"]["loss"])
        grads = grad_diff(r0["grads"], ref["grads"])
        stats = max(float((r["stats"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                    for r in ranks for k, v in ref["stats"].items())
        same = all(r["scalars"] == r0["scalars"] and all(
            torch.equal(g, r["grads"][n]) for n, g in r0["grads"].items()) for r in ranks)
        # the sp ranks of one dp coordinate load the same samples; rank =
        # d * sp + s here
        same_samples = all(torch.equal(r["first_view"], ranks[i - i % 2]["first_view"])
                           for i, r in enumerate(ranks))
        row = dict(loss=r0["scalars"]["loss"], loss_one_process=ref["scalars"]["loss"],
                   loss_rel_diff=loss, grad_rel_l2_diff=grads,
                   grad_rel_l2_diff_yardstick_phase_6=yardstick, stats_rel_diff=stats,
                   scalars_and_grads_identical_on_ranks=same,
                   sp_ranks_load_the_same_samples=same_samples,
                   per_rank_batch=[r["per_rank_batch"] for r in ranks],
                   launches_per_rank=[r["launches"] for r in ranks],
                   all_reduce_per_step_rank0=r0["all_reduce"],
                   peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
                   peak_mem_gb_one_process=ref_train_peak,
                   ms_per_step_ranks_sharing_one_card_over_gloo=[r["ms_per_step"] for r in ranks],
                   ms_per_step_one_process_phase_6=one_process_ms,
                   ranks_run_s=runs[task]["seconds"], before=runs[task]["before"])
        if not (np.isfinite(r0["scalars"]["loss"]) and loss <= LOSS_RTOL and same
                and same_samples and stats <= STAT_RTOL
                and all(grads[k] <= tol for k, tol in PATH_GRAD_RTOL.items())):
            raise AssertionError(f"{task} step against one process: {row}")
        return row

    fwd = [r["forward"] for r in runs["sp"]["ranks"]]
    diffs = [(f["depth"] - ref_depth).abs() for f in fwd]
    depth = dict(max_mm=max(float(x.max()) for x in diffs),
                 mean_mm=max(float(x.mean()) for x in diffs),
                 p99_mm=max(float(torch.quantile(x.flatten()[::7], 0.99)) for x in diffs))
    c_err = max(float((f["conf"] - ref_conf).abs().max()) for f in fwd)
    for i, f in enumerate(fwd):
        expect_launches(f"sp forward rank {i}", f["launches"], warp_correlate=6)
    bands = {f"stage{s + 1}": [b - a for a, b in spatial.row_bands(H // 2 ** (2 - s), 2)]
             for s in range(3)}
    forward = dict(bands_rows=bands, depth_diff_from_one_process=depth,
                   numerics_tol=dict(mean_mm=0.2, p99_mm=2.0, max_mm=10.0),
                   conf_max_abs_diff=c_err, unsplit_passes=[f["unsplit_passes"] for f in fwd],
                   launches_per_rank=[f["launches"] for f in fwd],
                   all_reduce_rank0=fwd[0]["all_reduce"],
                   peak_mem_gb_per_rank=[f["peak_mem_gb"] for f in fwd],
                   peak_mem_gb_one_process=ref_eval_peak,
                   ms_per_forward_2_ranks_sharing_one_card_over_gloo=[
                       f["ms_per_forward"] for f in fwd],
                   seconds=fwd[0]["seconds"])
    if not (depth["max_mm"] <= 0.05 and c_err <= 1e-3
            and all(f["unsplit_passes"] == 0 for f in fwd)):
        raise AssertionError(f"sp forward against one process: {forward}")

    clis = [r["cli"] for r in runs["sp"]["ranks"]]
    for i, c in enumerate(clis):
        # one step and one validation batch
        expect_launches(f"sp cli rank {i}", c["launches"], warp_correlate=12,
                        warp_correlate_grad_ref=6, warp_correlate_grad_src=6)
    epoch = clis[0]["history"][0]
    if not (all(c["step"] == 1 for c in clis) and all(
            np.isfinite(v) for v in (*epoch["train_avg"].values(), *epoch["val_avg"].values()))
            and clis[1]["history"][0]["train_avg"] == epoch["train_avg"]
            and os.path.exists(epoch["checkpoint"])):
        raise AssertionError(f"sp cli: {clis}")
    return dict(init=[r["init"] for r in runs["dpsp"]["ranks"]],
                backend=runs["sp"]["ranks"][0]["backend"],
                gb_held_by_this_process_before=[held_before / 1e9, held_before_eval / 1e9],
                forward=forward,
                step_sp2=held("sp"), step_dp2_sp2=held("dpsp"),
                cli=dict(launches_per_rank=[c["launches"] for c in clis], steps=clis[0]["step"],
                         train_avg=epoch["train_avg"], val_avg=epoch["val_avg"],
                         seconds=clis[0]["seconds"]),
                seconds=time.perf_counter() - t_total)


class _Tee:
    """A text stream that writes to ``out`` and keeps what it wrote."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


@contextlib.contextmanager
def run_test_line():
    """Within the block stdout is kept and every engine/evaluate
    model_summary result recorded; at exit the yielded dict holds "lines",
    the printed lines that start with "params:", and "summaries"."""
    kept = {"lines": [], "summaries": []}
    tee, real_stdout, real_summary = _Tee(sys.stdout), sys.stdout, evaluate.model_summary

    def recording(model, *args):
        kept["summaries"].append(real_summary(model, *args))
        return kept["summaries"][-1]

    sys.stdout, evaluate.model_summary = tee, recording
    try:
        yield kept
    finally:
        sys.stdout, evaluate.model_summary = real_stdout, real_summary
        kept["lines"] = [x for x in "".join(tee.parts).splitlines() if x.startswith("params:")]


def trace_kernel_events(trace_dir: str) -> dict[str, list[float]]:
    """The device kernels of a ``profiler.device_trace`` Chrome trace, by
    hand-written kernel (the name of its __global__ function): their
    durations in ms; "other" for every other kernel."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = {name: [] for name in (*cuda_build.KERNELS, "other")}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        # the longest name that matches: gated_warp_correlate_kernel also
        # holds warp_correlate_kernel
        name = max((k for k in cuda_build.KERNELS if f"{k}_kernel" in e.get("name", "")),
                   key=len, default="other")
        out[name].append(e.get("dur", 0.0) / 1e3)
    return out


def cost_phase(dev, tmp: str, eval_main: dict, eval_line: dict, train: dict) -> dict:
    """Phase 24, the cost model (engine/profiler): params, FLOPs and bytes
    per map of the dtu_test forward at batch 2 on phase 5's scene and
    weights, on the kernel path, the plain path and the epipolar-routed
    model (default routing); the kinds of the kernel path's count; FLOPs
    and bytes of one dtu_train step (phase 6's weights and validation batch,
    Adam at learning rate 0) on both paths; the rates over phase 5's ms per
    map and phase 6's ms per step; one forward under device_trace, whose
    trace must name kernel 1 six times; and phase 5's run_test line, which
    must have appeared once with the kernel path's count."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(eval_argv(tmp)))
    model = build_model(cfg, dev)
    imgs, proj, dv = load_batch(cfg, dev)

    def summary(impl: str) -> dict:
        model.warp_impl = impl
        return profiler.model_summary(model, imgs, proj, dv)

    kernel, plain, epi = summary("cuda"), summary("torch"), summary("epipolar")
    model.warp_impl = "cuda"
    if kernel != plain or epi["flops"] != kernel["flops"] or epi["params"] != kernel["params"]:
        raise AssertionError(f"cost: kernel path {kernel}, plain path {plain}, epipolar {epi}")
    with torch.no_grad():
        kinds = profiler.cost_breakdown(model, imgs, proj, dv)
    if {k: float(sum(v.values())) for k, v in kinds.items()} != {
            k: kernel[k] for k in ("flops", "bytes_accessed")}:
        raise AssertionError(f"cost: breakdown {kinds} against {kernel}")
    want = f"params: {kernel['params']:,}  flops: {kernel['flops']:.3e}  " \
           f"bytes: {kernel['bytes_accessed']:.3e}"
    if eval_line["lines"] != [want] or eval_line["summaries"] != [kernel]:
        raise AssertionError(f"cost: run_test printed {eval_line['lines']} "
                             f"({eval_line['summaries']}), expected [{want!r}]")

    trace_dir = os.path.join(tmp, "trace")
    with torch.inference_mode(), profiler.device_trace(trace_dir):
        model(imgs, proj, dv)
    traced = trace_kernel_events(trace_dir)
    if len(traced["warp_correlate"]) != 6:
        raise AssertionError(f"cost: the trace names kernel 1 {len(traced['warp_correlate'])} "
                             f"times, expected 6; kernels traced: "
                             f"{ {k: len(v) for k, v in traced.items()} }")
    del model

    tcfg, sd, batch = option_inputs(dev, tmp, train["checkpoint"])
    step = make_train_step(tuple(tcfg.dlossw), tcfg.depth_mode)

    def step_cost(impl: str) -> dict:
        net = train_model(tcfg, sd, dev)
        net.warp_impl = impl
        optimizer, scheduler = make_optimizer(net.parameters(), lambda i: 0.0)
        return profiler.cost_breakdown(step, net, optimizer, scheduler, batch)

    step_kernel, step_plain = step_cost("cuda"), step_cost("torch")
    if step_kernel != step_plain:
        raise AssertionError(f"cost: train step kernel path {step_kernel}, plain {step_plain}")
    step_flops = sum(step_kernel["flops"].values())
    step_bytes = sum(step_kernel["bytes_accessed"].values())

    def rates(flops: float, nbytes: float, ms: float) -> dict:
        return dict(ms=ms, tflop_s=flops / ms / 1e9, share_of_fp32_peak=flops / ms * 1e3 / PEAK_FP32_S,
                    gb_s=nbytes / ms / 1e6, share_of_hbm=nbytes / ms * 1e3 / PEAK_BYTES_S)

    ms_map, ms_step = eval_main["ms_per_map_kernel"], train["train_step_ms"]
    return dict(
        params=kernel["params"], batch=B,
        flops_per_map=kernel["flops"] / B, bytes_per_map=kernel["bytes_accessed"] / B,
        plain_path_equal=True, epipolar_flops_per_map=epi["flops"] / B,
        epipolar_bytes_per_map=epi["bytes_accessed"] / B,
        flops_per_map_by_kind={k: v / B for k, v in kinds["flops"].items()},
        bytes_per_map_by_kind={k: v / B for k, v in kinds["bytes_accessed"].items()},
        train_batch=int(batch["imgs"].shape[0]), flops_per_step=step_flops,
        bytes_per_step=step_bytes, flops_per_step_by_kind=step_kernel["flops"],
        bytes_per_step_by_kind=step_kernel["bytes_accessed"],
        eval_rate=rates(kernel["flops"] / B, kernel["bytes_accessed"] / B, ms_map),
        train_rate=rates(step_flops, step_bytes, ms_step),
        run_test_line=eval_line["lines"][0],
        trace_kernels={k: len(v) for k, v in traced.items()},
        trace_kernel_ms={k: sum(v) for k, v in traced.items()})


def _fold_diffs(got_depth, want_depth, got_conf, want_conf) -> dict:
    """|depth| (mm: mean, p99 over every 7th pixel, max) and |confidence|
    (max) differences of two maps on the host."""
    d = (got_depth.double() - want_depth.double()).abs()
    return dict(depth_mean_mm=float(d.mean()),
                depth_p99_mm=float(torch.quantile(d.flatten()[::7], 0.99)),
                depth_max_mm=float(d.max()),
                conf_max_abs_diff=float((got_conf.double() - want_conf.double()).abs().max()))


def fold_eval(model, imgs, proj, dv, card: str) -> tuple[dict, list[dict], dict]:
    """Phase 25's eval rows on one model toggled between the plans: maps,
    launches, folded convolutions, ms per map, peak memory; one row per
    (stage, pass) timing its cost U-Net on the model's own cost volume under
    each plan (a pass the shape rule declines is also timed forced folded);
    the feature net's ms under each plan.  Returns (eval row, pass rows,
    the folded maps on the host)."""
    captured = {}
    hooks = [model.feature.register_forward_pre_hook(
        lambda m, a: captured.setdefault("feature", a[0]))]
    for s in range(len(NDEPTHS)):
        for name, reg in ((f"s{s + 1} main", model.cost_regularization[s]),
                          (f"s{s + 1} refine", model.cost_regularization_refine[s])):
            hooks.append(reg.register_forward_pre_hook(
                lambda m, a, k=name: captured.setdefault(k, a[0])))
    runs = {}
    for plan in (False, True, None):
        model.fold_level0 = plan
        cuda_build.reset_launches()
        before = dict(folded.stats)
        with torch.inference_mode():
            o = model(imgs, proj, dv)
        torch.cuda.synchronize()
        runs[plan] = dict(depth=o["depth"].cpu(), conf=o["photometric_confidence"].cpu(),
                          launches=cuda_build.launches(),
                          folded={k: v - before[k] for k, v in folded.stats.items()})
        while hooks:   # the inputs of the first (unfolded) forward
            hooks.pop().remove()
        expect_launches(f"fold eval ({plan})", runs[plan]["launches"], warp_correlate=6)
    want_folded = {True: dict(convolutions=FOLDED_CONVS, declined=FOLDED_DECLINED),
                   None: dict(convolutions=0, declined=0)}
    for plan, want in want_folded.items():
        if runs[plan]["folded"] != want:
            raise AssertionError(f"fold eval ({plan}): folded {runs[plan]['folded']}, "
                                 f"expected {want}")
    diffs = _fold_diffs(runs[True]["depth"], runs[False]["depth"], runs[True]["conf"],
                        runs[False]["conf"])
    if not (diffs["depth_max_mm"] <= 0.05 and diffs["conf_max_abs_diff"] <= 1e-3):
        raise AssertionError(f"fold eval: folded against unfolded {diffs}")
    timing = {}
    for plan in (False, True):
        model.fold_level0 = plan
        timing[plan] = forward_timing(model, imgs, proj, dv)

    def unet(reg, x, plan: str):
        """The U-Net's two branches on ``x`` in the plan (folded also where
        the shape rule would decline it)."""
        def call():
            with torch.inference_mode():
                return torch.cat([getattr(b, plan)(x) for b in (reg.cosR_small, reg.cosR_huge)],
                                 1)
        return call

    rows = []
    for s in range(len(NDEPTHS)):
        for name, reg in ((f"s{s + 1} main", model.cost_regularization[s]),
                          (f"s{s + 1} refine", model.cost_regularization_refine[s])):
            x = captured[name]
            call_u, call_f = unet(reg, x, "_unfolded"), unet(reg, x, "_folded")
            ms_u, ms_f = time_ms(call_u, 5), time_ms(call_f, 5)
            err = float((call_f().float() - call_u().float()).abs().max())
            rows.append(dict(pass_name=name, shape_bcdhw=list(x.shape),
                             folds=folded.use_folded_level0(x),
                             folded_channels=x.shape[1] * x.shape[2] * 4,
                             unfolded_ms=ms_u, folded_ms=ms_f,
                             folded_over_unfolded=ms_f / ms_u, max_abs_diff=err, card=card))
    feature_ms = {}
    for plan in (False, True):
        model.feature.fold_level0 = plan

        def feature():
            with torch.inference_mode():
                return model.feature(captured["feature"])
        feature_ms["folded" if plan else "unfolded"] = time_ms(feature, 5)
    model.fold_level0 = None
    row = dict(batch=B, maps_folded_vs_unfolded=diffs,
               bounds=dict(depth_max_mm=0.05, conf_max=1e-3),
               numerics_tol=dict(mean_mm=0.2, p99_mm=2.0, max_mm=10.0),
               launches={str(k): r["launches"] for k, r in runs.items()},
               folded_per_forward={str(k): r["folded"] for k, r in runs.items()},
               ms_per_map_unfolded=timing[False]["ms_per_map"],
               ms_per_map_folded=timing[True]["ms_per_map"],
               peak_mem_gb_unfolded=timing[False]["peak_mem_gb"],
               peak_mem_gb_folded=timing[True]["peak_mem_gb"],
               feature_net_ms=feature_ms,
               unet_ms_sum={"unfolded": sum(r["unfolded_ms"] for r in rows),
                            "folded_where_the_rule_folds": sum(
                                r["folded_ms"] if r["folds"] else r["unfolded_ms"] for r in rows)},
               card=card)
    return row, rows, runs[True]


def fold_phase(dev, tmp: str, train: dict, bf16e: dict, cost: dict) -> dict:
    """Phase 25, "fold": the folded level-0 plan (models/folded.py) against
    the unfolded one on the card.  Eval (``fold_eval``) on phase 5's batch
    and weights; one dtu_train step from phase 6's weights on its
    validation batch under deterministic cuDNN with fold on against fold off
    (LOSS_RTOL, PATH_GRAD_RTOL beside phase 6's yardstick, STAT_RTOL), 6 +
    6 + 6 launches, ms per step and peak memory under each; one forward at
    --costreg_dtype bfloat16 with fold on against phase 5's fp32 maps
    (BF16_TOL) beside phase 19's unfolded bf16 difference; one sp = 2 eval
    forward with fold on (``--rank-task spfold``) against the one-process
    folded forward (phase 23's bounds); phase 24's counts under the folded
    plan.  Every row carries the card's name and power limit."""
    card = card_line()
    out = {}
    cfg = cli.config_from_args(cli.build_parser().parse_args(eval_argv(tmp)))
    model = build_model(cfg, dev)
    imgs, proj, dv = load_batch(cfg, dev)
    t0 = time.perf_counter()
    out["eval"], out["passes"], folded_maps = fold_eval(model, imgs, proj, dv, card)
    out["eval"]["seconds"] = time.perf_counter() - t0

    # phase 24's count under the folded plan
    t0 = time.perf_counter()
    model.fold_level0 = True
    counted = profiler.model_summary(model, imgs, proj, dv)
    model.fold_level0 = None
    del model
    tcfg, sd, batch = option_inputs(dev, tmp, train["checkpoint"])
    net = train_model(tcfg, sd, dev)
    net.fold_level0 = True
    optimizer, scheduler = make_optimizer(net.parameters(), lambda i: 0.0)
    step_count = profiler.cost_breakdown(make_train_step(tuple(tcfg.dlossw), tcfg.depth_mode),
                                         net, optimizer, scheduler, batch)
    del net, optimizer, scheduler
    step_flops = sum(step_count["flops"].values())
    step_bytes = sum(step_count["bytes_accessed"].values())
    out["cost"] = dict(flops_per_map=counted["flops"] / B,
                       bytes_per_map=counted["bytes_accessed"] / B,
                       flops_per_step=step_flops, bytes_per_step=step_bytes,
                       equal_to_phase_24=True, card=card,
                       seconds=time.perf_counter() - t0)
    if (counted["flops"] / B, counted["bytes_accessed"] / B, step_flops, step_bytes) != (
            cost["flops_per_map"], cost["bytes_per_map"], cost["flops_per_step"],
            cost["bytes_per_step"]):
        raise AssertionError(f"fold cost: {out['cost']} against phase 24's {cost}")

    # one train step, fold on against fold off
    t0 = time.perf_counter()
    runs = {}
    for plan in (False, True):
        net = train_model(tcfg, sd, dev)
        net.fold_level0 = plan
        runs[plan] = dict(step_grads(net, tcfg, batch), **step_timing(net, tcfg, batch))
        expect_launches(f"fold step ({plan})", runs[plan]["launches"], warp_correlate=6,
                        warp_correlate_grad_ref=6, warp_correlate_grad_src=6)
        del net
    off, on = runs[False], runs[True]
    loss_rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    grads = grad_diff(on["grads"], off["grads"])
    stat_err = max(float((on["state"][k].double() - v.double()).abs().max())
                   / max(1.0, float(v.abs().max()))
                   for k, v in off["state"].items() if ".running_" in k)
    tracked_equal = all(torch.equal(on["state"][k], v) for k, v in off["state"].items()
                        if k.endswith("num_batches_tracked"))
    out["train"] = dict(loss_unfolded=off["loss"], loss_folded=on["loss"], loss_rel_diff=loss_rel,
                        grad_rel_l2_diff=grads, grad_bounds=PATH_GRAD_RTOL,
                        grad_rel_l2_diff_yardstick_phase_6=train["grad_rel_l2_diff_yardstick"],
                        stat_rel_diff=stat_err, stat_bound=STAT_RTOL,
                        launches=on["launches"], ms_per_step_unfolded=off["ms_per_step"],
                        ms_per_step_folded=on["ms_per_step"],
                        peak_mem_gb_unfolded=off["peak_mem_gb"],
                        peak_mem_gb_folded=on["peak_mem_gb"], card=card,
                        seconds=time.perf_counter() - t0)
    if not (np.isfinite(on["loss"]) and loss_rel <= LOSS_RTOL and stat_err <= STAT_RTOL
            and tracked_equal
            and all(np.isfinite(grads[k]) and grads[k] <= t for k, t in PATH_GRAD_RTOL.items())):
        raise AssertionError(f"fold step against unfolded step: {out['train']}")
    del runs, batch
    torch.cuda.empty_cache()

    # bf16 cost U-Nets, folded, against phase 5's fp32 maps
    t0 = time.perf_counter()
    bcfg = cli.config_from_args(cli.build_parser().parse_args(
        eval_argv(tmp) + ["--costreg_dtype", "bfloat16"]))
    model = build_model(bcfg, dev)
    model.fold_level0 = True
    with torch.inference_mode():
        o = model(imgs, proj, dv)
    want = [torch.from_numpy(np.stack([io.read_pfm(os.path.join(tmp, "out", "scan1", kind,
                                                               f"{v:08d}.pfm"))[0]
                                       for v in range(B)]).astype(np.float32))
            for kind in ("depth_est", "confidence")]
    diffs = _fold_diffs(o["depth"].cpu(), want[0], o["photometric_confidence"].cpu(), want[1])
    conf_mean = float((o["photometric_confidence"].cpu() - want[1]).abs().mean())
    out["bf16"] = dict(costreg_dtype="bfloat16", against_phase_5_fp32_maps=diffs,
                       conf_mean=conf_mean, tol=BF16_TOL,
                       phase_19_unfolded_nets={k: bf16e["nets"][k] for k in (
                           "depth_mean_mm", "depth_p99_mm", "depth_max_mm", "conf_mean")},
                       card=card, seconds=time.perf_counter() - t0)
    if not (diffs["depth_mean_mm"] <= BF16_TOL["mean_mm"]
            and diffs["depth_p99_mm"] <= BF16_TOL["p99_mm"]
            and diffs["depth_max_mm"] <= BF16_TOL["max_mm"]
            and conf_mean <= BF16_TOL["conf_mean"]):
        raise AssertionError(f"fold bf16 against fp32: {out['bf16']}")
    del model, o, imgs, proj, dv
    gc.collect()
    torch.cuda.empty_cache()

    # sp = 2 with the folded plan, against the one-process folded forward
    t0 = time.perf_counter()
    d = os.path.join(tmp, "sp_fold")
    os.makedirs(d)
    with open(os.path.join(d, "task.json"), "w") as f:
        json.dump(dict(test_argv=eval_argv(tmp), fold_level0=True), f)
    run_ranks(["chip_smoke.py", "--rank-task", "spfold", "--task-dir", d], 2)
    fwd = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)["forward"]
           for r in range(2)]
    per_rank = [_fold_diffs(f["depth"], folded_maps["depth"], f["conf"], folded_maps["conf"])
                for f in fwd]
    for i, f in enumerate(fwd):
        expect_launches(f"fold sp forward rank {i}", f["launches"], warp_correlate=6)
    out["sp"] = dict(against_one_process_folded=per_rank, bounds=dict(depth_max_mm=0.05,
                                                                      conf_max=1e-3),
                     unsplit_passes=[f["unsplit_passes"] for f in fwd],
                     folded_per_rank=[f["folded"] for f in fwd],
                     launches_per_rank=[f["launches"] for f in fwd],
                     all_reduce_rank0=fwd[0]["all_reduce"],
                     peak_mem_gb_per_rank=[f["peak_mem_gb"] for f in fwd],
                     ms_per_forward_2_ranks_sharing_one_card_over_gloo=[
                         f["ms_per_forward"] for f in fwd],
                     card=card, seconds=time.perf_counter() - t0)
    if not (all(r["depth_max_mm"] <= 0.05 and r["conf_max_abs_diff"] <= 1e-3 for r in per_rank)
            and all(f["unsplit_passes"] == 0 for f in fwd)
            and all(f["folded"] == dict(convolutions=FOLDED_CONVS, declined=FOLDED_DECLINED)
                    for f in fwd)):
        raise AssertionError(f"fold sp forward against one process: {out['sp']}")
    return out


def report(every: list[dict], eval_launches, train_launches, epi_launches,
           fallback_launches, recipes: dict[str, dict], parallel: dict[str, dict],
           options: dict[str, dict]) -> None:
    """The "kernels" line, from the rows of the five kernels on synthetic
    and model inputs and the gated pass's rows on one tank_adaptive map
    (phase 26); ``recipes`` are the launch counts of each recipe path
    of phases 11-15, each read just after the path ran from counts at 0;
    ``parallel`` those of phases 16-18 and 23 (per rank on the gloo paths);
    ``options`` those of the model options' paths, phases 19-22, and of the
    folded plan's, phase 25."""

    def rows_of(kernel, inputs, cameras="translate"):
        return [r for r in every if r.get("kernel", "warp_correlate") == kernel
                and r["inputs"] == inputs and r.get("cameras", "translate") == cameras]

    def atomics(rows) -> dict:
        """The scatter's counters summed over the passes of ``rows``."""
        return {k: sum(r[k] for r in rows)
                for k in ("uncombined_atomic_adds", "global_atomic_adds", "cell_moves")}

    def kernel_entry(name, replaces, launches, rows, model=(), **extra):
        """A kernel's sums over its passes; the bound is the sum of the
        per-pass bounds (six launches, each bound by its own bytes or
        operations), ``bound_by`` what bounds the larger share of it;
        ``max_abs_err`` the largest over every row held, the recipes' rows
        included."""
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            by[r["bound_by"]] += r["bound_ms"]
        library = [r["library_ms"] for r in rows if "library_ms" in r]
        orbit = rows_of(name, "synthetic", "orbit")
        held = [r for inputs in (*RECIPE_INPUTS, "model vp", "model bf16 eval")
                for r in rows_of(name, inputs)]
        extra["recipe_launches"] = {path: n[name] for path, n in recipes.items()}
        extra["parallel_launches"] = {path: n[name] for path, n in parallel.items()}
        extra["option_launches"] = {path: n[name] for path, n in options.items()}
        vp = rows_of(name, "model vp")
        extra["vp_model_ms"] = sum(r["kernel_ms"] for r in vp) if vp else None
        bf16 = rows_of(name, "model bf16 eval")
        extra["bf16_eval_model_ms"] = sum(r["kernel_ms"] for r in bf16) if bf16 else None
        extra["recipe_model_ms"] = {inputs: sum(r["kernel_ms"] for r in rows_of(name, inputs))
                                    for inputs in RECIPE_INPUTS if rows_of(name, inputs)}
        return {"name": name, "route": "cuda", "source": f"dmvsnet_tpu_torch/csrc/{name}.cu",
                "replaces": f"dmvsnet_tpu/ops/pallas/{replaces}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in (*rows, *model, *orbit, *held)),
                "ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
                "library_ms": sum(library) if library else None,
                "model_ms": sum(r["kernel_ms"] for r in model) if model else None,
                "orbit_ms": sum(r["kernel_ms"] for r in orbit),
                "orbit_plain_ms": sum(r["plain_ms"] for r in orbit),
                "orbit_max_abs_err": max(r["max_abs_err"] for r in orbit), **extra}

    # ms, plain_ms, library_ms and bound_ms are sums over the six passes of
    # one forward (eval shapes; for the resample kernel its four launches per
    # pass) or one backward (train shapes) on the smoke's synthetic inputs;
    # vp_model_ms kernel 1 on rank 0's six passes of the vp forward (phase 18);
    # bf16_eval_model_ms kernel 1 on the six passes of one bf16 dtu_test batch
    # (phase 19, the features upcast); option_launches those of phases 19-22
    # and 25;
    # model_ms the same on the inputs of one dtu_test batch (kernel 1), one
    # dtu_train step (kernels 2 and 3) or one dtu_test batch of the epipolar
    # model with all six passes routed (kernels 4 and 5); recipe_model_ms
    # the same on one pass set of each recipe (RECIPE_INPUTS); launches are
    # those of the path that was driven with the counts at 0 just before
    # it; the scatter's atomic adds are summed over the same passes
    print(json.dumps({"kernels": [
        kernel_entry("warp_correlate", "warp_correlate.py:147",
                     eval_launches["warp_correlate"], rows_of("warp_correlate", "synthetic"),
                     model=rows_of("warp_correlate", "model eval"),
                     model_ms_train_forward=sum(r["kernel_ms"] for r in rows_of(
                         "warp_correlate", "model train")),
                     train_path_launches=train_launches["warp_correlate"],
                     epipolar_path_launches=epi_launches["warp_correlate"],
                     epipolar_fallback_case_launches=fallback_launches["warp_correlate"]),
        kernel_entry("warp_correlate_grad_src", "warp_correlate.py:287",
                     train_launches["warp_correlate_grad_src"],
                     rows_of("warp_correlate_grad_src", "synthetic"),
                     model=rows_of("warp_correlate_grad_src", "model train"),
                     atomics=atomics(rows_of("warp_correlate_grad_src", "synthetic")),
                     model_atomics=atomics(rows_of("warp_correlate_grad_src", "model train"))),
        kernel_entry("warp_correlate_grad_ref", "warp_correlate.py:227",
                     train_launches["warp_correlate_grad_ref"],
                     rows_of("warp_correlate_grad_ref", "synthetic"),
                     model=rows_of("warp_correlate_grad_ref", "model train")),
        kernel_entry("resample", "epipolar_sweep.py:63", epi_launches["resample"],
                     rows_of("resample", "synthetic"), model=rows_of("resample", "model eval")),
        kernel_entry("sweep1d", "epipolar_sweep.py:251", epi_launches["sweep1d"],
                     rows_of("sweep1d", "synthetic"), model=rows_of("sweep1d", "model eval")),
        gated_entry(rows_of("gated_warp_correlate", "model tank adaptive"), options),
    ]}), flush=True)


def gated_entry(rows: list[dict], options: dict[str, dict]) -> dict:
    """The gated pass's entry of the "kernels" line: its six passes of one
    tank_adaptive map (phase 26) summed, beside the per-pair route's time on
    the same inputs and kernel 1's bound for the pass."""
    return {"name": "gated_warp_correlate", "route": "cuda",
            "source": "dmvsnet_tpu_torch/csrc/warp_correlate_gated.cu",
            "replaces": "no TPU kernel: the adaptive pass's per-pair route",
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "model_ms": sum(r["kernel_ms"] for r in rows),
            "pairs_ms": sum(r["pairs_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "option_launches": {path: n["gated_warp_correlate"] for path, n in options.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grad-trials", type=int, default=0,
                        help="fresh sets of weights to repeat the gradient comparison on")
    parser.add_argument("--rank-task", choices=["cli", "gloo", "sp", "dpsp", "spfold"],
                        help="run as a rank of phase 16, 17-18, 23 or 25 (the script starts "
                             "these itself under torchrun)")
    parser.add_argument("--task-dir", help="where a rank reads its task and writes its results")
    args = parser.parse_args()
    grad_trials = args.grad_trials
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing run")
    if args.rank_task:
        rank_worker(args.rank_task, args.task_dir)
        return
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    pin_fp32()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    seconds = {}

    def timed(name, fn, *args):
        """Runs one phase and keeps its wall seconds for the "phases" line."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    if len(cuda_build.build()) != 6:
        raise AssertionError(f"expected six kernels, built {sorted(cuda_build.build())}")
    seconds["build"] = time.perf_counter() - t0
    print(f"build: {cuda_build.BUILD_INFO['seconds']:.2f}s with load "
          f"({time.perf_counter() - t0:.2f}s)", flush=True)
    for name, info in cuda_build.BUILD_INFO["kernels"].items():
        print(f"build: {name} built={info['built']} {info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    rows = timed("kernel_1", kernel_vs_plain, dev)
    adj_rows = timed("kernels_2_3", adjoints_vs_plain, dev)
    resample_rows = timed("kernel_4", resample_vs_plain, dev)
    sweep_rows = timed("kernel_5", sweep_vs_plain, dev)
    timed("ab", ab_per_pass, dev)
    fallback = timed("fallback", fallback_case, dev)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        def eval_main_path():
            t0 = time.perf_counter()
            synthetic.write_eval_scene(os.path.join(tmp, "data"), "scan1", height=H, width=W,
                                       n_views=V, seed=0)
            print(f"scene: {time.perf_counter() - t0:.2f}s", flush=True)
            argv = eval_argv(tmp)
            cuda_build.reset_launches()
            selections = blocks.conv_selections()
            t0 = time.perf_counter()
            with run_test_line() as line:
                summary = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            selections = blocks.conv_selections() - selections
            eval_launches = cuda_build.launches()
            expected = {"warp_correlate": 6 * run_test_forwards(-(-V // B)),
                        "warp_correlate_grad_ref": 0,
                        "warp_correlate_grad_src": 0, "resample": 0, "sweep1d": 0,
                        "gated_warp_correlate": 0}
            if summary["maps"] != V or eval_launches != expected:
                raise AssertionError(f"main path: {summary['maps']} maps, launches "
                                     f"{eval_launches} (expected {V} and {expected})")
            check_pfms(os.path.join(tmp, "out"), V)
            cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
            batch, eval_captured = check_batch(cfg, dev)
            d = summary["dispatch_seconds"]
            main = dict(maps=summary["maps"], launches=eval_launches["warp_correlate"],
                        conv_selections=selections, run_test_wall_s=wall, dispatch_s=d,
                        ms_per_map_after_first_dispatch=1e3 * sum(d[1:]) / (V - B), **batch)
            print("main " + json.dumps(main), flush=True)
            # kernel 1 on the model's own cost-pass inputs
            return eval_launches, model_rows(eval_captured, "model eval"), main, line

        eval_launches, model, eval_main, eval_line = timed("eval", eval_main_path)

        epi, epi_launches, (resamples, sweeps) = timed("epipolar", epipolar_path, dev, tmp)
        print("epipolar " + json.dumps(epi), flush=True)
        # kernels 4 and 5 on the epipolar model's own inputs
        model += epipolar_model_rows(resamples, sweeps)
        del resamples, sweeps

        train, train_launches, train_captured = timed("train", train_path, dev, tmp, grad_trials)
        print("train " + json.dumps(train), flush=True)
        # kernels 1-3 on the model's own cost-pass inputs
        model += model_rows(train_captured, "model train")
        del train_captured

        # the shipped test recipes through the CLI; kernels 1-3 on the
        # tensors of the gate's first overfit step, kernel 1 on those of
        # one tank_test map (six passes, D = 64 at stage 1), kernels 1-3 on
        # those of the first BlendedMVS step
        captured = []
        with capture_calls(wc, "warp_correlate_grad", captured, first_pass_set(captured),
                           to="cpu"):
            gate, weights = timed("gate", geometry_gate, dev, tmp)
        print("gate " + json.dumps(gate), flush=True)
        model += model_rows(captured, "model gate")
        dtu, pfm = timed("recipe_dtu", recipe_dtu, dev, tmp, weights)
        print("recipe_dtu " + json.dumps(dtu), flush=True)
        print("vis " + json.dumps(timed("vis", vis_phase, tmp, pfm)), flush=True)
        captured = []
        with capture_calls(wc, "warp_correlate", captured, first_pass_set(captured),
                           to="cpu"):
            tank = timed("recipe_tank", recipe_tank, dev, tmp, weights)
        print("recipe_tank " + json.dumps(tank), flush=True)
        model += model_rows(captured, "model tank")
        captured = []
        torch.cuda.empty_cache()
        with capture_calls(wc, "warp_correlate_grad", captured, first_pass_set(captured),
                           to="cpu"):
            bmvs = timed("blendedmvs", blendedmvs_path, dev, tmp, train["checkpoint"])
        print("blendedmvs " + json.dumps(bmvs), flush=True)
        model += model_rows(captured, "model blendedmvs")
        del captured

        # data parallelism: torchrun with nccl at world size 1, then two
        # ranks sharing the one card over gloo; kernel 1 on rank 0's vp passes.
        # The ranks share the card with this process: free what the earlier
        # phases left in reference cycles first
        gc.collect()
        torch.cuda.empty_cache()
        nccl = timed("dp_nccl", dp_nccl, tmp, train_argv(tmp, "logs_nccl"), train["checkpoint"])
        print("dp_nccl " + json.dumps(nccl), flush=True)
        dp, vp, vp_passes = timed("dp_vp_gloo", gloo_ranks, dev, tmp, train_argv(tmp, "logs_gloo"),
                                  eval_argv(tmp), train["checkpoint"],
                                  train["grad_rel_l2_diff_yardstick"], train["train_step_ms"])
        print("dp_gloo " + json.dumps(dp), flush=True)
        print("vp " + json.dumps(vp), flush=True)
        model += model_rows(vp_passes, "model vp")
        del vp_passes

        # the model options: the bf16 policies, remat, adaptive aggregation;
        # kernel 1 on the upcast inputs of one bf16 batch
        gc.collect()
        torch.cuda.empty_cache()
        bf16e, captured = timed("bf16_eval", bf16_eval, dev, tmp)
        print("bf16_eval " + json.dumps(bf16e), flush=True)
        model += model_rows(captured, "model bf16 eval")
        del captured
        inputs = timed("option_inputs", option_inputs, dev, tmp, train["checkpoint"])
        yardstick = train["grad_rel_l2_diff_yardstick"]
        bf16t = timed("bf16_train", bf16_train, dev, inputs, yardstick)
        print("bf16_train " + json.dumps(bf16t), flush=True)
        remat = timed("remat", remat_phase, dev, inputs)
        print("remat " + json.dumps(remat), flush=True)
        adaptive = timed("adaptive", adaptive_phase, dev, tmp, inputs, yardstick)
        print("adaptive " + json.dumps(adaptive), flush=True)
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
        model += timed("gated", gated_phase, dev)

        # the spatial mesh axis: ranks sharing the one card over gloo, each
        # regularising its band of rows
        gc.collect()
        torch.cuda.empty_cache()
        sp = timed("sp", sp_phase, dev, tmp, train_argv(tmp, "logs_sp"), eval_argv(tmp),
                   train_argv(tmp, "logs_sp_cli") + ["--max_train_samples", "2"],
                   train["checkpoint"], yardstick, train["train_step_ms"])
        print("sp " + json.dumps(sp), flush=True)

        gc.collect()
        torch.cuda.empty_cache()
        cost = timed("cost", cost_phase, dev, tmp, eval_main, eval_line, train)
        print("cost " + json.dumps(cost), flush=True)

        # the folded level-0 plan against the unfolded one
        gc.collect()
        torch.cuda.empty_cache()
        fold = timed("fold", fold_phase, dev, tmp, train, bf16e, cost)
        for row in fold["passes"]:
            print("fold_pass " + json.dumps(row), flush=True)
        for key in ("eval", "train", "bf16", "sp", "cost"):
            print(f"fold_{key} " + json.dumps(fold[key]), flush=True)

    print("phases " + json.dumps({"seconds": seconds, "total": sum(seconds.values()),
                                  "conv_selections": blocks.conv_selections()}), flush=True)
    report(rows + adj_rows + resample_rows + sweep_rows + model, eval_launches, train_launches,
           epi_launches, fallback["launches"],
           dict(gate_overfit=gate["train_launches"], gate_test=gate["test_launches"],
                recipe_dtu=dtu["launches"], recipe_tank=tank["launches"],
                blendedmvs=bmvs["launches"]),
           dict(dp_nccl_run=nccl["launches"], dp_gloo_step_rank0=dp["launches_per_rank"][0],
                vp_forward_rank0=vp["forward"]["launches_per_rank"][0],
                vp_step_rank0=vp["step"]["launches_per_rank"][0],
                sp_forward_rank0=sp["forward"]["launches_per_rank"][0],
                sp_step_rank0=sp["step_sp2"]["launches_per_rank"][0],
                dp2_sp2_step_rank0=sp["step_dp2_sp2"]["launches_per_rank"][0],
                sp_cli_rank0=sp["cli"]["launches_per_rank"][0]),
           dict(bf16_eval_nets=bf16e["nets"]["launches"],
                bf16_eval_compute=bf16e["compute"]["launches"],
                bf16_train_step=bf16t["launches"], remat_step=remat["launches"]["remat"],
                no_remat_step=remat["launches"]["no_remat"],
                adaptive_eval=adaptive["cli_launches"], adaptive_step=adaptive["step_launches"],
                fold_eval=fold["eval"]["launches"]["True"], fold_step=fold["train"]["launches"],
                fold_sp_forward_rank0=fold["sp"]["launches_per_rank"][0]))
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
