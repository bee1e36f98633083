"""Seeded synthetic scenes for every cell: one general generator, driven by
a workload file's parameters.

After ``dmvsnet_tpu_torch/utils/synthetic.py`` at commit 1e68102 (its
pinhole camera stacks, its orbit rig that turns each view about three axes
as a DTU rig's cameras turn, its smooth Fourier texture and its stage
projections at 1/4, 1/2 and 1 of the full intrinsics), rebuilt so that a
scene is made on the device from a ``torch.Generator`` in a few calls: a
textured plane at a random depth and tilt, rendered by ray casting into
every view, with the reference view's depth as ground truth.

Traffic parameters (the workload file's ``traffic`` object):

* ``scenes``: size of the pool that the window cycles through;
* ``depth_range``: [min, max] of the D0 hypotheses handed to the model (mm);
* ``plane_depth``: [min, max] of the plane's depth on the reference axis;
* ``tilt_deg``: the largest tilt of the plane's normal from the axis;
* ``rig``: {"step_deg": [yaw, pitch, roll] per orbit step, "focal": focal
  length over image width};
* ``texture``: {"terms": sinusoids per channel, "scales": their spatial
  frequencies in cycles per mm};
* ``holes``: largest share of the reference view's width and height of the
  one rectangle per scene whose ground truth is masked out (training).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _rotation(yaw: float, pitch: float, roll: float) -> torch.Tensor:
    """Rz(roll) @ Rx(pitch) @ Ry(yaw), radians, float64."""
    cy, sy, cp, sp, cr, sr = (math.cos(yaw), math.sin(yaw), math.cos(pitch),
                              math.sin(pitch), math.cos(roll), math.sin(roll))
    ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=torch.float64)
    rx = torch.tensor([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=torch.float64)
    rz = torch.tensor([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], dtype=torch.float64)
    return rz @ rx @ ry


def orbit_cameras(views: int, height: int, width: int, target_depth: float,
                  rig: dict) -> torch.Tensor:
    """(V, 2, 4, 4) float64 [extrinsics; intrinsics] stacks at full
    resolution: view 0 the identity, view i k = ceil(i/2) orbit steps out on
    alternate sides, turned to look at (0, 0, ``target_depth``)."""
    f = rig["focal"] * width
    target = torch.tensor([0.0, 0.0, target_depth], dtype=torch.float64)
    cams = torch.zeros(views, 2, 4, 4, dtype=torch.float64)
    for i in range(views):
        k = (i + 1) // 2
        sign = 1.0 if i % 2 else -1.0
        rot = _rotation(*(math.radians(sign * k * a) for a in rig["step_deg"]))
        centre = target - target_depth * rot.T @ torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
        cams[i, 0, :3, :3] = rot
        cams[i, 0, :3, 3] = -rot @ centre
        cams[i, 0, 3, 3] = 1.0
        cams[i, 1, :3, :3] = torch.tensor([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                                          dtype=torch.float64)
        cams[i, 1, 3, 3] = 1.0
    return cams


def render(gen: torch.Generator, traffic: dict, views: int, height: int, width: int,
           device) -> dict[str, torch.Tensor]:
    """One scene on ``device``: imgs (V, H, W, 3) in [0, 1], cams (V, 2, 4,
    4) at full resolution, depth (H, W) of the reference view, mask (H, W)."""
    u = torch.rand(8, generator=gen, device=device, dtype=torch.float64).cpu()
    lo, hi = traffic["plane_depth"]
    z0 = lo + (hi - lo) * float(u[0])
    tilt = math.radians(traffic["tilt_deg"]) * float(u[1])
    azimuth = 2.0 * math.pi * float(u[2])
    normal = torch.tensor([math.sin(tilt) * math.cos(azimuth), math.sin(tilt) * math.sin(azimuth),
                           math.cos(tilt)], dtype=torch.float64)
    cams = orbit_cameras(views, height, width, z0, traffic["rig"])

    tex = traffic["texture"]
    n_terms = tex["terms"]
    coeffs = torch.rand(3, len(tex["scales"]), n_terms, 3, generator=gen, device=device)
    phase = coeffs[..., 0] * (2.0 * math.pi)
    angle = coeffs[..., 1] * (2.0 * math.pi)
    freq = torch.tensor(tex["scales"], device=device)[None, :, None] * (0.5 + coeffs[..., 2])
    kx = (2.0 * math.pi) * freq * torch.cos(angle)
    ky = (2.0 * math.pi) * freq * torch.sin(angle)

    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float64),
                            torch.arange(width, device=device, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)])               # (3, H, W)
    c = float(normal @ torch.tensor([0.0, 0.0, z0], dtype=torch.float64))
    n_dev = normal.to(device)
    imgs, ref_depth = [], None
    for v in range(views):
        rot, t = cams[v, 0, :3, :3], cams[v, 0, :3, 3]
        kinv = torch.linalg.inv(cams[v, 1, :3, :3])
        rays = torch.einsum("ij,jhw->ihw", (rot.T @ kinv).to(device), pix)
        origin = (-rot.T @ t).to(device)
        s = (c - n_dev @ origin) / torch.einsum("i,ihw->hw", n_dev, rays)
        px = (origin[0] + s * rays[0]).float()
        py = (origin[1] + s * rays[1]).float()
        arg = kx[..., None, None] * px + ky[..., None, None] * py + phase[..., None, None]
        img = torch.sin(arg).sum(dim=(1, 2)).permute(1, 2, 0)        # (H, W, 3)
        lo_c = img.amin(dim=(0, 1), keepdim=True)
        hi_c = img.amax(dim=(0, 1), keepdim=True)
        imgs.append((img - lo_c) / (hi_c - lo_c + 1e-6))
        if v == 0:
            ref_depth = s.float()
    hole = traffic.get("holes", 0.0)
    mask = torch.ones(height, width, device=device)
    if hole:
        hh, hw = max(1, int(hole * height * float(u[3]))), max(1, int(hole * width * float(u[4])))
        y0, x0 = int((height - hh) * float(u[5])), int((width - hw) * float(u[6]))
        mask[y0:y0 + hh, x0:x0 + hw] = 0.0
    return {"imgs": torch.stack(imgs), "cams": cams.float().to(device), "depth": ref_depth,
            "mask": mask}


def stage_projections(cams: torch.Tensor, num_stage: int) -> dict[str, torch.Tensor]:
    """{"stage{i}": (..., V, 2, 4, 4)}: intrinsics scaled 1/4, 1/2, 1."""
    out = {}
    for s in range(num_stage):
        p = cams.clone()
        p[..., 1, :2, :] *= 2.0 ** (s - (num_stage - 1))
        out[f"stage{s + 1}"] = p
    return out


def pool(seed: int, traffic: dict, views: int, height: int, width: int, num_stage: int,
         numdepth: int, device) -> list[dict[str, np.ndarray]]:
    """The cell's pool of ``traffic["scenes"]`` samples in host memory
    (numpy, as a data loader hands them over): imgs (V, H, W, 3),
    proj_matrices per stage, depth_values (D0,), depth and mask per stage."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d_lo, d_hi = traffic["depth_range"]
    dv = np.linspace(d_lo, d_hi, numdepth, dtype=np.float32)
    samples = []
    for _ in range(traffic["scenes"]):
        scene = render(gen, traffic, views, height, width, device)
        depth, mask = {}, {}
        for s in range(num_stage):
            k = 2 ** (num_stage - 1 - s)
            depth[f"stage{s + 1}"] = scene["depth"][::k, ::k].cpu().numpy()
            mask[f"stage{s + 1}"] = scene["mask"][::k, ::k].cpu().numpy()
        samples.append({
            "imgs": scene["imgs"].cpu().numpy(),
            "proj_matrices": {k: v.cpu().numpy()
                              for k, v in stage_projections(scene["cams"], num_stage).items()},
            "depth_values": dv, "depth": depth, "mask": mask})
    return samples


def batches(samples: list[dict], batch: int, count: int) -> list[dict[str, np.ndarray]]:
    """``count`` batches of ``batch`` samples, sample i of batch k being
    pool entry (k * batch + i) mod len(pool), stacked as a loader stacks
    them (numpy, contiguous)."""

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([x[k] for x in items]) for k in items[0]}
        return np.ascontiguousarray(np.stack(items))

    return [stack([samples[(k * batch + i) % len(samples)] for i in range(batch)])
            for k in range(count)]
