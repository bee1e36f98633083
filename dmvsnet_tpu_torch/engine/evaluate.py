"""Depth-map inference runner (port of dmvsnet_tpu.engine.evaluate.run_test).

Once per run, at the first batch: the model's params / FLOPs / bytes line
(``engine/profiler.model_summary``, the reference's thop print).  Per
scene: the T&T resolution override, a fresh eval dataset, the infer
step per batch of reference views (the tail batch padded by repetition),
and the reference-compatible outputs depth_est/*.pfm, confidence/*.pfm,
cams/*_cam.txt, images/*.jpg; then point-cloud fusion of every scan
(``filter_method`` pcd or dypcd, on the host in numpy) into
``outdir/pcd/*.ply``.  ``run_visualization`` renders one depth PFM as a
PNG.
"""

from __future__ import annotations

import concurrent.futures
import os
import time

import cv2
import numpy as np
import torch

from dmvsnet_tpu_torch import (CONV_CANDIDATES, measured_conv_algorithms, pin_fp32,
                               resolve_device)
from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
from dmvsnet_tpu_torch.data.splits import resolve_scan_list
from dmvsnet_tpu_torch.engine import colormap
from dmvsnet_tpu_torch.engine.checkpoint import restore_weights
from dmvsnet_tpu_torch.engine.profiler import model_summary
from dmvsnet_tpu_torch.engine.steps import make_infer_step
from dmvsnet_tpu_torch.engine.train import build_model as build_train_model
from dmvsnet_tpu_torch.fusion import TANK_SCENE_CONFIG, dypcd_filter, pcd_filter
from dmvsnet_tpu_torch.models import MVSNet


def build_model(cfg: Config, device: torch.device) -> MVSNet:
    """The eval MVSNet of ``cfg`` on ``device``: weights from ``cfg.resume``
    (a reference-layout torch state dict, or a checkpoint holding one under
    "model"), else a seeded random init from ``cfg.seed``."""
    model = build_train_model(cfg, device)
    if cfg.resume:
        restore_weights(cfg.resume, model)
    return model.eval()


def run_test(cfg: Config, device: str | torch.device | None = None) -> dict:
    """Depth inference over ``cfg``'s scans; runs on CUDA unless
    ``device="cpu"``.

    Before the first dispatch, prints the model's ``params: N  flops: F
    bytes: B`` line (``engine/profiler.model_summary`` of one forward of
    the first batch, which runs the model once more, outside the timed
    dispatches).

    Returns {"maps": depth maps written, "dispatch_seconds": wall seconds
    of each infer dispatch (host copy of the result included),
    "device": the device, "fusion_seconds": wall seconds of the fusion of
    all scans (0.0 without fusion), "ply": the fused point cloud of each
    scan, in scan order ([] without fusion)}; under
    ``warp_impl="epipolar"`` also "sweep_engaged": per dispatch {"stage1",
    "stage1_refine", ...: (B, V-1) nested bool lists}, which (batch element, source view) of each cost pass
    took the rectified sweep (the others took the exact kernel).
    """
    device = resolve_device(device)
    if cfg.filter_method not in ("pcd", "dypcd", "none", ""):
        raise NotImplementedError(
            f"filter_method={cfg.filter_method!r} (gipuma is disabled in the "
            "reference too, filter/__init__.py:1)")
    # cuDNN defaults fp32 convolutions to TF32; the port is held to the
    # fp32 reference, so TF32 is off for convolutions and matmuls
    pin_fp32()

    if cfg.testpath_single_scene:
        # single-scene mode: datapath = parent dir, scan = basename
        cfg = cfg.replace(datapath=os.path.dirname(cfg.testpath_single_scene))
        scans = [os.path.basename(cfg.testpath_single_scene)]
    else:
        scans = resolve_scan_list(cfg.testlist, cfg.datapath)
    model = build_model(cfg, device)
    infer = make_infer_step()
    maps, dispatch_seconds, engaged, summarized = 0, [], [], False

    def record(_module, _args, out):
        stages = [k for k in out if k.startswith("stage")]
        engaged.append({k + suffix: out[k]["sweep_engaged" + suffix].tolist()
                        for k in stages for suffix in ("", "_refine")})

    # fix_res latch carried across the per-scene datasets
    latched_hw = None
    for scene in scans:
        max_h, max_w = cfg.max_h, cfg.max_w
        if scene in TANK_SCENE_CONFIG:
            sc = TANK_SCENE_CONFIG[scene]
            max_h, max_w = sc.max_h, sc.max_w

        ds = GeneralEvalDataset(
            cfg.datapath, [scene], nviews=cfg.num_view, ndepths=cfg.numdepth,
            interval_scale=cfg.interval_scale, max_h=max_h, max_w=max_w,
            fix_res=cfg.fix_res, inverse_depth=cfg.inverse_depth,
            fixed_hw=latched_hw,
        )
        eb = max(1, int(cfg.eval_batch))

        def load_batch(start):
            samples = [ds[i] for i in range(start, min(start + eb, len(ds)))]
            nreal = len(samples)
            # pad the tail batch by repetition: one shape per scene,
            # padded outputs discarded below
            samples = samples + [samples[-1]] * (eb - nreal)
            imgs = np.stack([s["imgs"] for s in samples])
            proj = {k: np.stack([s["proj_matrices"][k] for s in samples])
                    for k in samples[0]["proj_matrices"]}
            dvb = np.stack([s["depth_values"] for s in samples])
            return samples, nreal, imgs, proj, dvb

        # one-batch-ahead prefetch: decode batch k+1 on a worker thread
        # while the device runs batch k
        starts = list(range(0, len(ds), eb))
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            futures = {starts[0]: pool.submit(load_batch, starts[0])} if starts else {}
            for si, start in enumerate(starts):
                samples, nreal, imgs_np, proj_np, dv_np = futures.pop(start).result()
                if si + 1 < len(starts):
                    futures[starts[si + 1]] = pool.submit(load_batch, starts[si + 1])
                imgs = torch.from_numpy(imgs_np).to(device)
                proj = {k: torch.from_numpy(v).to(device) for k, v in proj_np.items()}
                dv = torch.from_numpy(dv_np).to(device)
                if not summarized:
                    # the one-time params / FLOPs line (the reference's thop
                    # print), counted on one forward of this batch, untimed;
                    # the first to meet each convolution problem, it chooses
                    # algorithms as the infer step does, which then keeps them
                    with measured_conv_algorithms(CONV_CANDIDATES):
                        s = model_summary(model, imgs, proj, dv)
                    print(f"params: {s['params']:,}  flops: {s['flops']:.3e}  "
                          f"bytes: {s['bytes_accessed']:.3e}", flush=True)
                    if model.warp_impl == "epipolar":
                        model.register_forward_hook(record)
                    summarized = True

                t0 = time.perf_counter()
                depth_b, conf_b = infer(model, imgs, proj, dv)
                depth_b = depth_b.cpu().numpy()
                conf_b = conf_b.cpu().numpy()
                dt = time.perf_counter() - t0
                dispatch_seconds.append(dt)
                print(f"{scene} [{start}..{start + nreal - 1}/{len(ds)}] "
                      f"{depth_b.shape[1:]} {dt:.3f}s", flush=True)

                for j in range(nreal):
                    sample, depth, conf = samples[j], depth_b[j], conf_b[j]
                    fname = sample["filename"]
                    io.save_pfm(os.path.join(cfg.outdir, fname.format("depth_est", ".pfm")),
                                depth.astype(np.float32))
                    io.save_pfm(os.path.join(cfg.outdir, fname.format("confidence", ".pfm")),
                                conf.astype(np.float32))
                    io.write_cam_file(os.path.join(cfg.outdir, fname.format("cams", "_cam.txt")),
                                      sample["proj_matrices"]["stage3"][0])
                    img_path = os.path.join(cfg.outdir, fname.format("images", ".jpg"))
                    os.makedirs(os.path.dirname(img_path), exist_ok=True)
                    cv2.imwrite(img_path, cv2.cvtColor(
                        np.clip(sample["imgs"][0] * 255, 0, 255).astype(np.uint8),
                        cv2.COLOR_RGB2BGR))
                    maps += 1
        if cfg.fix_res:
            latched_hw = ds.latched_hw

    fused = cfg.filter_method in ("pcd", "dypcd")
    t0 = time.perf_counter()
    if fused:
        fusion_args = {
            "datapath": cfg.datapath, "outdir": cfg.outdir, "conf": tuple(cfg.conf),
            "thres_view": cfg.thres_view, "dist_base": cfg.dist_base,
            "rel_diff_base": cfg.rel_diff_base, "num_stage": len(cfg.ndepths),
        }
        if cfg.filter_method == "pcd":
            pcd_filter(fusion_args, scans, cfg.num_worker)
        else:
            dypcd_filter(fusion_args, scans, 1)
    summary = {"maps": maps, "dispatch_seconds": dispatch_seconds, "device": str(device),
               "fusion_seconds": time.perf_counter() - t0 if fused else 0.0,
               "ply": [ply_path(cfg.outdir, scan) for scan in scans] if fused else []}
    if model.warp_impl == "epipolar":
        summary["sweep_engaged"] = engaged
    return summary


def ply_path(outdir: str, scan: str) -> str:
    """Where fusion writes a scan's cloud: DTU's MATLAB naming for scanN,
    else the scene name (the rule of the fusion workers' ``_scan_worker``)."""
    name = (f"mvsnet{int(scan[4:]):03d}_l3.ply"
            if scan.startswith("scan") and scan[4:].isdigit() else f"{scan}.ply")
    return os.path.join(outdir, "pcd", name)


def run_visualization(depth_path: str, save_dir: str = ".") -> str:
    """PFM -> magma-colormapped PNG at the 95th percentile
    (reference model.py:392-410); returns the PNG's path.  The colormap is
    engine/colormap.py's, byte-equal to the JAX package's matplotlib one."""
    from PIL import Image

    depth, _ = io.read_pfm(depth_path)
    rgb = colormap.magma_rgb(depth, depth.min(), np.percentile(depth, 95))
    out = os.path.join(save_dir, "depth.png")
    os.makedirs(save_dir, exist_ok=True)
    Image.fromarray((rgb * 255).astype(np.uint8)).save(out)
    return out
