"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (nvidia-smi name and power limit), torch / CUDA versions and
   the TF32 flags (pinned off: the port is held to the fp32 reference);
2. build of the hand-written CUDA kernel from dmvsnet_tpu_torch/csrc/;
3. kernel vs its plain PyTorch version on the card at the six cost-pass
   shapes of DTU eval (864x1152, 5 views, batch 2, ndepths 48/32/8 + the
   4-plane refine passes): max |diff| against 1e-4 * max(1, max|plain|),
   kernel and plain times (median of CUDA-event-timed runs) beside the
   least time the card could take (bytes over 3.35 TB/s, fp32 operations
   over 67 TFLOP/s: H100 SXM data sheet);
4. the main path: run_test through the CLI at --preset dtu_test on a
   synthetic 864x1152, 5-view scene (eval_batch 2: three dispatches, the
   last padded), with seeded random weights.  Checks every PFM, checks that
   the kernel launched exactly 6 cost passes x 3 dispatches, then checks
   one batch of the same model against the same model with plain cost
   passes, and that each stage's depths lie inside the hypotheses they
   were regressed from;
5. a "kernels" JSON line, the card line, and the final
   {"ok": true, "device": {...}} line.

Exits non-zero without a result when CUDA is unavailable, or when run
outside the repository (the port is not importable).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dmvsnet_tpu_torch import pin_fp32
from dmvsnet_tpu_torch.core import geometry, sampling
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
from dmvsnet_tpu_torch.engine.evaluate import build_model
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic
from dmvsnet_tpu_torch import cli

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, V, B = 864, 1152, 5, 2
NDEPTHS = (48, 32, 8)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_S = 67e12      # H100 SXM fp32 without tensor cores
KERNEL_REPS, PLAIN_REPS = 20, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event-timed calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pass_cost(b, v, d, h, w, c):
    """Least bytes (each input read once, the output written once) and fp32
    operations (10*C + 20 per pixel, plane and source view) of one pass."""
    nbytes = 4 * (b * d * h * w + b * d * h * w * 2 + b * v * h * w * c + b * (v - 1) * 12)
    flops = b * d * h * w * (v - 1) * (10 * c + 20)
    return nbytes, flops


def stage_cameras() -> dict[str, torch.Tensor]:
    cams = np.stack([synthetic.camera_stack(1.2 * W, 1.2 * W, W / 2, H / 2,
                                            tx=-12.0 * i, angle=0.01 * i)
                     for i in range(V)])
    return {k: torch.from_numpy(np.broadcast_to(p, (B, *p.shape)).copy()).cuda()
            for k, p in synthetic.stage_projections(cams).items()}


def kernel_vs_plain(dev) -> list[dict]:
    """Phase 3: the kernel against its plain version at the six pass shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    projs = stage_cameras()
    depth_values = torch.from_numpy(
        (1.0 / np.linspace(1 / 500.0, 1 / 788.0, 192, endpoint=False)).astype(np.float32)
    )[None].repeat(B, 1).to(dev)
    rows = []
    for s, (c, nd) in enumerate(zip((32, 16, 8), NDEPTHS)):
        scale = 2 ** (2 - s)
        h, w = H // scale, W // scale
        feats = torch.randn((B, V, h, w, c), generator=gen, device=dev)
        rel = geometry.relative_projections(projs[f"stage{s + 1}"])
        main, _ = sampling.stage1_samples(depth_values, nd, h, w, inverse=True)
        # refine fan: 4 planes per pixel spread far enough to reach zero and
        # negative depths
        fan = 600.0 + 400.0 * torch.randn((B, 4, h, w), generator=gen, device=dev)
        fan[:, 0, 0, :8] = 0.0  # the z == 0 guard
        if not bool((fan < 0).any()):
            raise AssertionError("refine fan has no negative depth")
        for name, depth in ((f"s{s + 1} main", main.contiguous()), (f"s{s + 1} refine", fan)):
            got = wc.warp_correlate(feats, rel, depth)
            want = wc.warp_correlate_plain(feats, rel, depth)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            if not (np.isfinite(err) and err <= tol):
                raise AssertionError(f"{name}: kernel vs plain max |diff| {err} > {tol}")
            k_ms = time_ms(lambda: wc.warp_correlate(feats, rel, depth), KERNEL_REPS)
            p_ms = time_ms(lambda: wc.warp_correlate_plain(feats, rel, depth), PLAIN_REPS)
            nbytes, flops = pass_cost(B, V, depth.shape[1], h, w, c)
            row = dict(pass_=name, C=c, D=depth.shape[1], H=h, W=w, max_abs_err=err, tol=tol,
                       kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
                       bytes_ms=nbytes / PEAK_BYTES_S * 1e3, ops_ms=flops / PEAK_FP32_S * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            print("pass " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
            rows.append(row)
            del got, want
        del feats
        torch.cuda.empty_cache()
    return rows


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


def check_batch(cfg, dev) -> dict:
    """One batch of the main path: the kernel model vs the same weights with
    plain cost passes, the hypothesis envelopes, and steady-state times."""
    ds = GeneralEvalDataset(cfg.datapath, ["scan1"], nviews=cfg.num_view,
                            ndepths=cfg.numdepth, interval_scale=cfg.interval_scale,
                            max_h=cfg.max_h, max_w=cfg.max_w, inverse_depth=cfg.inverse_depth)
    samples = [ds[i] for i in range(B)]
    imgs = torch.from_numpy(np.stack([s["imgs"] for s in samples])).to(dev)
    proj = {k: torch.from_numpy(np.stack([s["proj_matrices"][k] for s in samples])).to(dev)
            for k in samples[0]["proj_matrices"]}
    dv = torch.from_numpy(np.stack([s["depth_values"] for s in samples])).to(dev)
    model = build_model(cfg, dev)
    if model.warp_impl != "cuda":
        raise AssertionError(f"main path resolved warp_impl={model.warp_impl!r}")

    def forward(impl):
        model.warp_impl = impl
        with torch.inference_mode():
            return model(imgs, proj, dv)

    out_k, out_p = forward("cuda"), forward("torch")
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
                depth_range_mm=[out_k["depth"].min().item(), out_k["depth"].max().item()])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing run")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    pin_fp32()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    wc.build()
    print(f"build: {wc.BUILD_INFO['seconds']:.2f}s built={wc.BUILD_INFO['built']} "
          f"({time.perf_counter() - t0:.2f}s with load) {wc.BUILD_INFO['path']}", flush=True)
    for line in wc.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    rows = kernel_vs_plain(dev)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        synthetic.write_eval_scene(os.path.join(tmp, "data"), "scan1", height=H, width=W,
                                   n_views=V, seed=0)
        print(f"scene: {time.perf_counter() - t0:.2f}s", flush=True)
        argv = ["--test", "--preset", "dtu_test", "--datapath", os.path.join(tmp, "data"),
                "--testlist", "scan1", "--outdir", os.path.join(tmp, "out"),
                "--filter_method", "none", "--eval_batch", str(B)]
        wc.LAUNCHES = 0
        t0 = time.perf_counter()
        summary = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wc.LAUNCHES
        expected = 6 * -(-V // B)
        if summary["maps"] != V or launches != expected:
            raise AssertionError(f"main path: {summary['maps']} maps, {launches} kernel "
                                 f"launches (expected {V} and {expected})")
        check_pfms(os.path.join(tmp, "out"), V)
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        batch = check_batch(cfg, dev)
    d = summary["dispatch_seconds"]
    print("main " + json.dumps(dict(
        maps=summary["maps"], launches=launches, run_test_wall_s=wall, dispatch_s=d,
        ms_per_map_after_first_dispatch=1e3 * sum(d[1:]) / (V - B), **batch)), flush=True)

    tot_bytes = sum(r["bytes"] for r in rows)
    tot_flops = sum(r["flops"] for r in rows)
    bytes_ms, ops_ms = tot_bytes / PEAK_BYTES_S * 1e3, tot_flops / PEAK_FP32_S * 1e3
    print(json.dumps({"kernels": [{
        "name": "warp_correlate",
        "route": "cuda",
        "source": "dmvsnet_tpu_torch/csrc/warp_correlate.cu",
        "replaces": "dmvsnet_tpu/ops/pallas/warp_correlate.py:147",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
