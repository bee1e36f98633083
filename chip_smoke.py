"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (nvidia-smi name and power limit), torch / CUDA versions and
   the TF32 flags (pinned off: the port is held to the fp32 reference);
2. build of the three hand-written CUDA kernels from dmvsnet_tpu_torch/csrc/
   (one nvcc per source, started together);
3. the forward kernel vs its plain PyTorch version on the card at the six
   cost-pass shapes of DTU eval (864x1152, 5 views, batch 2, ndepths
   48/32/8 + the 4-plane refine passes): max |diff| against
   1e-4 * max(1, max|plain|), kernel and plain times (median of
   CUDA-event-timed runs) beside the least time the card could take (bytes
   over 3.35 TB/s, fp32 operations over 67 TFLOP/s: H100 SXM data sheet);
4. the two adjoint kernels vs their plain version (autograd of the plain
   forward) at the six cost-pass shapes of DTU training (512x640, 5 views,
   batch 2), refine fans with zero and negative depths: max |diff| against
   1e-4 * max(1, max|plain|), no gradient for projections and depths, the
   run-to-run spread of the atomic scatter, times, bounds, atomic adds;
5. the eval main path: run_test through the CLI at --preset dtu_test on a
   synthetic 864x1152, 5-view scene (eval_batch 2: three dispatches, the
   last padded), with seeded random weights.  Checks every PFM, checks that
   the kernel launched exactly 6 cost passes x 3 dispatches, then checks
   one batch of the same model against the same model with plain cost
   passes, and that each stage's depths lie inside the hypotheses they
   were regressed from;
6. the training main path: the CLI at --preset dtu_train (512x640, 5 views,
   batch 2, fp32, Adam) on a synthetic DTU training tree: 3 train steps, a
   checkpoint, one validation batch; launch counts exactly 6 forward + 6 +
   6 adjoint launches per train step and 6 forward per validation batch;
   a second Trainer resumes epoch and optimizer step; one step's loss and
   gradients with kernel cost passes against plain cost passes; 8 steps on
   one fixed batch must lower the loss; ms per step and peak memory;
7. a "kernels" JSON line, the card line, and the final
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
from dmvsnet_tpu_torch.engine import checkpoint as ckpt_lib
from dmvsnet_tpu_torch.engine.evaluate import build_model
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.engine.train import Trainer
from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic
from dmvsnet_tpu_torch import cli

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, V, B = 864, 1152, 5, 2
NDEPTHS = (48, 32, 8)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_S = 67e12      # H100 SXM fp32 without tensor cores
KERNEL_REPS, PLAIN_REPS = 20, 3
TRAIN_H, TRAIN_W = 512, 640
# kernel-path vs plain-path train step: the cost volumes agree to ~1e-6, and
# the network between them and the loss (soft argmax, min/max composites)
# amplifies that
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-2


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


def stage_cameras(height: int = H, width: int = W) -> dict[str, torch.Tensor]:
    cams = np.stack([synthetic.camera_stack(1.2 * width, 1.2 * width, width / 2, height / 2,
                                            tx=-12.0 * i, angle=0.01 * i)
                     for i in range(V)])
    return {k: torch.from_numpy(np.broadcast_to(p, (B, *p.shape)).copy()).cuda()
            for k, p in synthetic.stage_projections(cams).items()}


def pass_cases(dev, height: int, width: int):
    """The six cost passes of one batch-2, 5-view cascade at height x width
    as (name, C, feats, rel, depth): per stage the main sweep and a 4-plane
    refine fan spread far enough to reach zero and negative depths."""
    gen = torch.Generator(device=dev).manual_seed(0)
    projs = stage_cameras(height, width)
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


def kernel_vs_plain(dev) -> list[dict]:
    """Phase 3: the forward kernel against its plain version at the six
    eval pass shapes."""
    rows = []
    for name, c, feats, rel, depth in pass_cases(dev, H, W):
        h, w = feats.shape[2:4]
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
        row = bound(dict(pass_=name, C=c, D=depth.shape[1], H=h, W=w, max_abs_err=err,
                         tol=tol, kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops))
        print("pass " + json.dumps({k.rstrip("_"): v for k, v in row.items()}), flush=True)
        rows.append(row)
        del got, want
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


def adjoint_cost(b, v, d, h, w, c, taps) -> dict[str, tuple[int, int]]:
    """Least bytes and fp32 operations of each adjoint kernel for one pass.
    Both read depth and the cotangent pair and the projections once.
    grad_ref: reads the source features, writes the reference gradient;
    8*C + 20 operations per (pixel, plane, view) (4 taps x C multiply-adds,
    the geometry) and 2*C per (pixel, plane) for the cotangent.
    grad_src: reads the reference features, writes the source gradient;
    2*C operations per (pixel, plane), 20 per (pixel, plane, view) and 2*C
    per tap that these inputs really add (``taps``)."""
    shared = b * d * h * w * 3 + b * (v - 1) * 12
    return {
        "warp_correlate_grad_ref": (
            4 * (shared + b * (v - 1) * h * w * c + b * h * w * c),
            b * d * h * w * ((v - 1) * (8 * c + 20) + 2 * c)),
        "warp_correlate_grad_src": (
            4 * (shared + b * h * w * c + b * (v - 1) * h * w * c),
            b * d * h * w * (2 * c + (v - 1) * 20) + taps * 2 * c),
    }


def plain_grad(feats, rel, depth, cot, wrt: str):
    """Autograd of the plain forward w.r.t. the reference slot ("ref") or
    the source slots ("src") alone: the plain version of one adjoint."""
    ref, src = feats[:, :1].detach(), feats[:, 1:].detach()
    leaf = (ref if wrt == "ref" else src).requires_grad_()
    out = wc.warp_correlate_plain(torch.cat([ref, src], 1), rel, depth)
    return torch.autograd.grad(out, leaf, cot)[0]


def adjoints_vs_plain(dev) -> list[dict]:
    """Phase 4: the adjoint kernels against autograd of the plain forward at
    the six train pass shapes, through the autograd.Function."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, c, feats, rel, depth in pass_cases(dev, TRAIN_H, TRAIN_W):
        h, w = feats.shape[2:4]
        d = depth.shape[1]
        cot = torch.randn((B, d, h, w, 2), generator=gen, device=dev)
        f, r, dep = (t.clone().requires_grad_() for t in (feats, rel, depth))
        wc.warp_correlate(f, r, dep).backward(cot)
        if r.grad is not None or dep.grad is not None:
            raise AssertionError(f"{name}: projections or depths received a gradient")
        got = f.grad
        want = wc.warp_correlate_grad_plain(feats, rel, depth, cot)
        again = wc.warp_correlate_grad_src(feats, rel, depth, cot)
        torch.cuda.synchronize()
        taps = count_taps(rel, depth, h, w)
        costs = adjoint_cost(B, V, d, h, w, c, taps)
        buf = torch.empty_like(feats)
        for kernel, sl, wrt, fn in (
                ("warp_correlate_grad_ref", slice(0, 1), "ref", wc.warp_correlate_grad_ref),
                ("warp_correlate_grad_src", slice(1, None), "src", wc.warp_correlate_grad_src)):
            err = (got[:, sl] - want[:, sl]).abs().max().item()
            tol = 1e-4 * max(1.0, want[:, sl].abs().max().item())
            if not (np.isfinite(err) and err <= tol):
                raise AssertionError(f"{name} {kernel}: max |diff| {err} > {tol}")
            row = dict(pass_=name, kernel=kernel, C=c, D=d, H=h, W=w, max_abs_err=err, tol=tol,
                       max_abs_plain=want[:, sl].abs().max().item())
            if wrt == "src":
                # fp32 atomics: two runs of the same scatter differ in the last bits
                row["spread"] = (again[:, sl] - got[:, sl]).abs().max().item()
                row["scalar_atomic_adds"] = taps * c
                row["vector_atomic_adds"] = taps * c // 4
                if not row["spread"] <= tol:
                    raise AssertionError(f"{name}: run-to-run spread {row['spread']} > {tol}")
            row["kernel_ms"] = time_ms(lambda: fn(feats, rel, depth, cot, buf), KERNEL_REPS)
            row["plain_ms"] = time_ms(lambda: plain_grad(feats, rel, depth, cot, wrt), PLAIN_REPS)
            row["bytes"], row["flops"] = costs[kernel]
            print("adjoint " + json.dumps({k.rstrip("_"): v for k, v in bound(row).items()}),
                  flush=True)
            rows.append(row)
        del got, want, again, buf, f, r, dep, cot
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


def train_path(dev, tmp: str) -> tuple[dict, dict]:
    """Phase 6: the trainer at the full dtu_train preset through the CLI,
    resume, kernel-path vs plain-path step, and an 8-step overfit."""
    t0 = time.perf_counter()
    data = os.path.join(tmp, "dtu")
    synthetic.write_dtu_training_tree(data, scans=("scan1",), n_views=V, height=TRAIN_H,
                                      width=TRAIN_W, seed=0)
    print(f"training tree: {time.perf_counter() - t0:.2f}s", flush=True)
    argv = ["--preset", "dtu_train", "--datapath", data, "--trainlist", "scan1",
            "--testlist", "scan1", "--log_dir", os.path.join(tmp, "logs"),
            "--max_train_samples", "6", "--max_val_samples", "2", "--epochs", "1",
            "--summary_freq", "1"]
    steps, val_batches = 3, 1
    wc.reset_launches()
    t0 = time.perf_counter()
    summary = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wc.LAUNCHES)
    expected = {"warp_correlate": 6 * (steps + val_batches),
                "warp_correlate_grad_ref": 6 * steps, "warp_correlate_grad_src": 6 * steps}
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

    def loss_and_grads(impl):
        model.warp_impl = impl
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss = mvs_loss(out, batch["depth"], batch["mask"], cfg.depth_mode, tuple(cfg.dlossw))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads("cuda")
    loss_p, grads_p = loss_and_grads("torch")
    model.warp_impl = "cuda"
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    grad_err, worst = max(
        ((grads_k[n] - g).norm().item() / max(g.norm().item(), 1e-30), n)
        for n, g in grads_p.items())
    if not (np.isfinite(loss_k) and loss_err <= LOSS_RTOL and grad_err <= GRAD_RTOL):
        raise AssertionError(f"kernel vs plain train step: loss {loss_k} vs {loss_p}, worst "
                             f"gradient {worst}: relative L2 diff {grad_err}")
    del grads_k, grads_p

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
    return dict(
        steps=summary["step"], launches=launches, cli_wall_s=wall,
        train_avg=epoch["train_avg"], val_avg=epoch["val_avg"],
        resumed_epoch=trainer.start_epoch, resumed_step=steps,
        loss_kernel=loss_k, loss_plain=loss_p, loss_rel_diff=loss_err,
        grad_rel_l2_diff_worst=grad_err, grad_worst_param=worst,
        overfit_losses=losses,
        train_step_ms=statistics.median(s.elapsed_time(e) for s, e in events[1:]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), launches


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
    print(f"build: {wc.BUILD_INFO['seconds']:.2f}s with load "
          f"({time.perf_counter() - t0:.2f}s)", flush=True)
    for name, info in wc.BUILD_INFO["kernels"].items():
        print(f"build: {name} built={info['built']} {info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    rows = kernel_vs_plain(dev)
    adj_rows = adjoints_vs_plain(dev)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        synthetic.write_eval_scene(os.path.join(tmp, "data"), "scan1", height=H, width=W,
                                   n_views=V, seed=0)
        print(f"scene: {time.perf_counter() - t0:.2f}s", flush=True)
        argv = ["--test", "--preset", "dtu_test", "--datapath", os.path.join(tmp, "data"),
                "--testlist", "scan1", "--outdir", os.path.join(tmp, "out"),
                "--filter_method", "none", "--eval_batch", str(B)]
        wc.reset_launches()
        t0 = time.perf_counter()
        summary = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eval_launches = dict(wc.LAUNCHES)
        expected = {"warp_correlate": 6 * -(-V // B), "warp_correlate_grad_ref": 0,
                    "warp_correlate_grad_src": 0}
        if summary["maps"] != V or eval_launches != expected:
            raise AssertionError(f"main path: {summary['maps']} maps, launches "
                                 f"{eval_launches} (expected {V} and {expected})")
        check_pfms(os.path.join(tmp, "out"), V)
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        batch = check_batch(cfg, dev)
        d = summary["dispatch_seconds"]
        print("main " + json.dumps(dict(
            maps=summary["maps"], launches=eval_launches["warp_correlate"], run_test_wall_s=wall,
            dispatch_s=d, ms_per_map_after_first_dispatch=1e3 * sum(d[1:]) / (V - B), **batch)),
            flush=True)

        train, train_launches = train_path(dev, tmp)
        print("train " + json.dumps(train), flush=True)

    def kernel_entry(name, source, replaces, launches, rows, **extra):
        total = bound(dict(bytes=sum(r["bytes"] for r in rows),
                           flops=sum(r["flops"] for r in rows)))
        return {"name": name, "route": "cuda", "source": f"dmvsnet_tpu_torch/csrc/{source}",
                "replaces": f"dmvsnet_tpu/ops/pallas/warp_correlate.py:{replaces}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
                "library_ms": None, **extra}

    # ms, plain_ms and bound_ms are sums over the six passes of one forward
    # (eval shapes) or one backward (train shapes); launches are those of
    # the path that was driven with the counts at 0 just before it
    print(json.dumps({"kernels": [
        kernel_entry("warp_correlate", "warp_correlate.cu", 147,
                     eval_launches["warp_correlate"], rows,
                     train_path_launches=train_launches["warp_correlate"]),
        kernel_entry("warp_correlate_grad_src", "warp_correlate_grad_src.cu", 287,
                     train_launches["warp_correlate_grad_src"],
                     [r for r in adj_rows if r["kernel"] == "warp_correlate_grad_src"]),
        kernel_entry("warp_correlate_grad_ref", "warp_correlate_grad_ref.cu", 227,
                     train_launches["warp_correlate_grad_ref"],
                     [r for r in adj_rows if r["kernel"] == "warp_correlate_grad_ref"]),
    ]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
