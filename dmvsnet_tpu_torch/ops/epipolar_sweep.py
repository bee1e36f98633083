"""The epipolar-rectified 1-D plane sweep: two CUDA kernels, their plain
PyTorch versions, and the per-pass routing between the sweep and the exact
2-D cost pass (port of dmvsnet_tpu.ops.pallas.epipolar_sweep).

After epipolar rectification (core/epipolar.py) matched points share
scanlines, so the per-plane work of a cost pass is a 1-D lerp along a row.
Per (ref, src) pair: one 2-D resample each of the source, the reference and
the 4 fan coefficients onto the rect grid (amortised over all D planes),
the 1-D sweep with its 2-group correlation, and one resample of the
D-folded volume back to the original grid.

Approximation: the two extra resamples low-pass the features and blend the
checkerboard hypothesis offsets, so this path is an eval-time option of the
model (``warp_impl="epipolar"``), gated per (batch element, view) by
validity checks with fallback to the exact 2-D kernel
(ops/warp_correlate.py).  It has no gradient: an input that requires one
raises.

Kernels (sources under ``csrc/``, each with a note on what bounds it on an
H100):

* ``resample`` (``resample.cu``) replaces the TPU kernel
  ``dmvsnet_tpu/ops/pallas/epipolar_sweep.py:_make_resample_kernel``.
* ``sweep1d`` (``sweep1d.cu``) replaces ``_make_sweep1d_kernel``.

Both are declared here and built at first use by ``ops/cuda_build.py``.
The wrappers take the plain versions only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.

Differences from the JAX package, by design: every function takes all the
pairs of a pass at once; the sweep-or-fallback decision is made on the host
from one small device tensor (the relative projections and the fan flags)
read back once per pass; the rectification's 3x3 algebra runs there too, on
CPU tensors, and goes to the card once (a measured choice: on the card it is
a few hundred tiny launches, and chip_smoke.py times the whole pass both
ways, its "ab" lines); the gates that only
ask whether a TPU window fits (``_resample_span_ok``, ``_sweep1d_span_ok``,
the row-group nesting) are dropped, because a CUDA thread gathers directly;
the channel order stays natural.
"""

from __future__ import annotations

import torch

from dmvsnet_tpu_torch.core import epipolar
from dmvsnet_tpu_torch.ops import cuda_build, warp, warp_correlate

# rectification sanity bounds: the scale factors of the similarity fits must
# stay near 1 (resolution loss / blow-up), and the epipole must be well
# outside the image (distortion of the rectifying homography), else the pair
# falls back to the 2-D kernel.
SCALE_MIN, SCALE_MAX = 0.5, 2.0
EPIPOLE_MARGIN = 1.2  # least epipole distance in image diagonals

# C arguments: resample(img, px, py, out, N, H, W, Ho, Wo, C, stream),
# sweep1d(src_r, ref_r, px, out, N, D, H, W, C, stream).  LAUNCHES counts
# launches per kernel; a wrapper adds one where it launches its kernel and
# nowhere else.
LAUNCHES: dict[str, int] = cuda_build.declare({
    "resample": ("resample.cu", cuda_build.pointer_ints(4, 6), ("warp_geometry.cuh",)),
    "sweep1d": ("sweep1d.cu", cuda_build.pointer_ints(4, 5), ()),
})


def _check_fp32(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# kernel 4: bilinear resample
# ---------------------------------------------------------------------------

def resample_plain(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the resample kernel, same contract."""
    return warp.bilinear_sample(img, px, py)


def resample(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear resample with zero padding: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args:
      img: (N, H, W, C) fp32 channels-last images, C a multiple of 4.
      px, py: (N, Ho, Wo) fp32 pixel coordinates into image n.

    Returns:
      (N, Ho, Wo, C) fp32; a tap outside the image contributes 0.
    """
    if img.dim() != 4 or img.shape[-1] % 4:
        raise ValueError(f"img must be (N, H, W, C) with C % 4 == 0, got {tuple(img.shape)}")
    n, h, w, c = img.shape
    if px.dim() != 3 or px.shape[0] != n or py.shape != px.shape:
        raise ValueError(f"px, py must be equal-shaped (N={n}, Ho, Wo), got "
                         f"{tuple(px.shape)} and {tuple(py.shape)}")
    _check_fp32(img.device, img=img, px=px, py=py)
    if img.device.type == "cpu":
        return resample_plain(img, px, py)
    ho, wo = px.shape[1:]
    out = torch.empty((n, ho, wo, c), dtype=torch.float32, device=img.device)
    if img.data_ptr() % 16:
        raise ValueError("img must be 16-byte aligned (float4 access)")
    cuda_build.launch("resample", (img, px, py, out), (n, h, w, ho, wo, c))
    return out


# ---------------------------------------------------------------------------
# kernel 5: the 1-D sweep + correlate
# ---------------------------------------------------------------------------

def sweep1d_plain(src_r: torch.Tensor, ref_r: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sweep kernel, same contract: gather the
    two columns of the pixel's own scanline, lerp, 2-group correlation."""
    n, h, w, c = src_r.shape
    p = px.clamp(-2.0, w + 1.0)
    x0 = torch.floor(p)
    wx = p - x0
    x0i = x0.long()
    rows = src_r.reshape(n * h, w, c)
    row = torch.arange(n * h, device=px.device).reshape(n, 1, h, 1)

    def tap(xi, wgt):
        valid = (xi >= 0) & (xi < w)
        return rows[row, xi.clamp(0, w - 1)] * (wgt * valid)[..., None]

    warped = tap(x0i, 1 - wx) + tap(x0i + 1, wx)            # (N, D, H, W, C)
    return warp.group_correlation(warped, ref_r)


def sweep1d(src_r: torch.Tensor, ref_r: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Per plane the 1-D lerp of the rectified source along the pixel's
    scanline, times the rectified reference, mean per channel group: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args:
      src_r, ref_r: (N, H, W, C) fp32 rectified features, C in 8/16/32,
        natural channel order (group g owns channels {2k+g}).
      px: (N, D, H, W) fp32 column coordinates on the rect grid; a column
        outside [0, W-1] contributes 0.

    Returns:
      (N, D, H, W, 2) fp32.
    """
    if src_r.dim() != 4 or ref_r.shape != src_r.shape:
        raise ValueError(f"src_r, ref_r must be equal-shaped (N, H, W, C), got "
                         f"{tuple(src_r.shape)} and {tuple(ref_r.shape)}")
    n, h, w, c = src_r.shape
    if px.dim() != 4 or px.shape[0] != n or tuple(px.shape[2:]) != (h, w):
        raise ValueError(f"px must be ({n}, D, {h}, {w}), got {tuple(px.shape)}")
    _check_fp32(src_r.device, src_r=src_r, ref_r=ref_r, px=px)
    if src_r.device.type == "cpu":
        return sweep1d_plain(src_r, ref_r, px)
    if c not in warp_correlate.CHANNELS:
        raise ValueError(f"kernel built for C in {warp_correlate.CHANNELS}, got {c}")
    d = px.shape[1]
    out = torch.empty((n, d, h, w, 2), dtype=torch.float32, device=src_r.device)
    if src_r.data_ptr() % 16 or ref_r.data_ptr() % 16:
        raise ValueError("src_r and ref_r must be 16-byte aligned (float4 access)")
    cuda_build.launch("sweep1d", (src_r, ref_r, px, out), (n, d, h, w, c))
    return out


# ---------------------------------------------------------------------------
# the hypothesis fan
# ---------------------------------------------------------------------------

def _fan_coeffs(dv: torch.Tensor):
    """(B, D, H, W) hypotheses -> per-pixel 2-parameter fan description.

    Two parameterisations cover every shipped hypothesis fan:

      * uniform in 1/d (the cascade samplers, core/sampling.py): the
        disparity px(d) = px_inf + b*(inv_lo + d*inv_step) is affine in the
        plane index, recovered exactly from the endpoints;
      * uniform in d (the 4-plane refine checkerboards: every stack6 slice
        in models/depth_net.py is arithmetic with step mx-mn):
        px(d) = px_inf + b / (lo + d*step).

    Returns (coeffs (B, H, W, 4) = [inv_lo, inv_step, lo, step], inv_ok (B,),
    dep_ok (B,)) where the *_ok booleans verify the respective
    parameterisation on the mid plane over all pixels of a batch element."""
    d = dv.shape[1]
    mid = d // 2

    inv = 1.0 / dv
    inv_lo = inv[:, 0]
    inv_step = (inv[:, -1] - inv[:, 0]) / (d - 1)
    pred = inv_lo + mid * inv_step
    inv_err = ((pred - inv[:, mid]).abs() / inv[:, mid].abs().clamp_min(1e-12)).amax((1, 2))

    lo = dv[:, 0]
    step = (dv[:, -1] - dv[:, 0]) / (d - 1)
    predd = lo + mid * step
    dep_err = ((predd - dv[:, mid]).abs() / dv[:, mid].abs().clamp_min(1e-12)).amax((1, 2))

    coeffs = torch.stack([inv_lo, inv_step, lo, step], dim=-1)
    # refine fans can cross zero depth -> inf in the (unused) inverse
    # channels; sanitise so the coefficient resample cannot smear NaNs into
    # neighbouring pixels (the *_ok flags are computed above, from the raw
    # values; a NaN error compares False)
    coeffs = torch.nan_to_num(coeffs, nan=0.0, posinf=0.0, neginf=0.0)
    return coeffs, inv_err < 1e-4, dep_err < 1e-4


def _fan_px(rect: epipolar.Rectification, coeffs: torch.Tensor, inv_mode: list[bool],
            dpl: int, h: int, w: int) -> torch.Tensor:
    """Per-plane column coordinates (N, D, H, W) on the rect grid from the
    resampled fan coefficients (N, H, W, 4).  ``inv_mode[n]`` selects the
    affine-in-1/d form (exact for cascade fans) for pair n; otherwise
    affine-in-d (refine fans), whose division is eps-guarded so an invalid
    fan yields huge-but-finite coordinates (zero-padded by the sweep)
    instead of NaNs.  Only the forms that some pair uses are computed."""
    px_inf, b = epipolar.affine_maps(rect, h, w)
    ds = torch.arange(dpl, dtype=torch.float32, device=coeffs.device)[None, :, None, None]
    px_inv = px_dep = None
    if any(inv_mode):
        px_inv = (px_inf + b * coeffs[..., 0])[:, None] + ds * (b * coeffs[..., 1])[:, None]
    if not all(inv_mode):
        denom = coeffs[..., 2][:, None] + ds * coeffs[..., 3][:, None]
        eps = torch.where(denom < 0, -1e-9, 1e-9).to(denom.dtype)
        safe = torch.where(denom.abs() < 1e-9, eps, denom)
        px_dep = px_inf[:, None] + b[:, None] / safe
    if px_dep is None:
        return px_inv
    if px_inv is None:
        return px_dep
    mask = torch.tensor(inv_mode, device=coeffs.device)[:, None, None, None]
    return torch.where(mask, px_inv, px_dep)


# ---------------------------------------------------------------------------
# gates and orchestration
# ---------------------------------------------------------------------------

def _supported(dpl: int, h: int, w: int, c: int) -> bool:
    """Static support: the fan needs >= 2 planes to fit a 2-parameter form,
    H and W must be even, and the folded D*2 channels must split into
    chunks of 8 (the JAX package's un-rectify chunk rule, kept so that both
    packages route every plane count alike; the resample kernel itself
    takes any multiple of 4)."""
    return (dpl >= 2 and h % 2 == 0 and w % 2 == 0 and (2 * dpl) % 8 == 0
            and c in warp_correlate.CHANNELS)


def _gates(rect: epipolar.Rectification, inv_ok: torch.Tensor, dep_ok: torch.Tensor,
           n_views: int, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The geometry and fan gates of N = B*(V-1) pairs from their
    Rectification and the (B,) fan flags: (take the sweep (N,) bool, the
    fan's mode inv_ok per pair (N,) bool)."""
    diag = float((h * h + w * w) ** 0.5)
    scales = rect.scales.abs()
    ok = ((scales > SCALE_MIN) & (scales < SCALE_MAX)).all(-1)
    ok &= rect.epipole_dist > EPIPOLE_MARGIN * diag
    ok &= (inv_ok | dep_ok).repeat_interleave(n_views)
    return ok, inv_ok.repeat_interleave(n_views)


def _host_gates(rel: torch.Tensor, inv_ok: torch.Tensor, dep_ok: torch.Tensor,
                h: int, w: int):
    """Rectification and gates of a pass on the host: ``rel`` (B, V-1, 3|4, 4)
    and the (B,) fan flags come back from the device in one read (the one
    synchronisation of the pass), and the 3x3 algebra runs on CPU tensors.
    Returns (Rectification of the B*(V-1) pairs on the CPU, and _gates of
    them: two (N,) bool tensors on the CPU)."""
    b, nv = rel.shape[:2]
    host = torch.cat([rel.reshape(-1).float(), inv_ok.float(), dep_ok.float()]).cpu()
    rect = epipolar.compute_rectification(host[:-2 * b].reshape(b * nv, *rel.shape[2:]), h, w)
    return rect, _gates(rect, host[-2 * b:-b] > 0, host[-b:] > 0, nv, h, w)


def sweep_engaged(rel: torch.Tensor, depth_values: torch.Tensor, h: int, w: int,
                  c: int) -> torch.Tensor:
    """Diagnostic: which (batch element, view) pairs of a pass take the 1-D
    sweep, and which fall back to the 2-D kernel.

    Args:
      rel: (B, V-1, 3|4, 4) relative projections of the source views.
      depth_values: (B, D, H, W) hypotheses.

    Returns:
      (B, V-1) bool tensor on the CPU, what aggregate_cost_volume_epipolar
      reports for the same inputs."""
    b, nv = rel.shape[:2]
    if not _supported(depth_values.shape[1], h, w, c):
        return torch.zeros((b, nv), dtype=torch.bool)
    _, inv_ok, dep_ok = _fan_coeffs(depth_values.float())
    return _host_gates(rel, inv_ok, dep_ok, h, w)[1][0].reshape(b, nv)


def epipolar_corr_pairs(
    src: torch.Tensor, ref: torch.Tensor, rect: epipolar.Rectification,
    coeffs0: torch.Tensor, inv_mode: list[bool], dpl: int,
) -> torch.Tensor:
    """The rectified sweep of N engaged pairs (the batched form of the JAX
    package's per-view ``sweep()``).

    Args:
      src, ref: (N, H, W, C) the pairs' source and reference features.
      rect: their Rectification, on the features' device.
      coeffs0: (N, H, W, 4) their fan coefficients on the original grid.
      inv_mode: their fan modes.

    Returns:
      (N, H, W, D*2) correlation volumes on the original ref grid, planes
      and groups folded into the channel axis.
    """
    n, h, w, _ = src.shape
    grid = epipolar.pixel_grid(h, w, src.device)
    rxx, rxy = epipolar.apply_h(rect.h_ref_inv, *grid)
    # the reference is rectified per pair: h_ref depends on the source view
    coeffs = resample(coeffs0, rxx, rxy)
    px = _fan_px(rect, coeffs, inv_mode, dpl, h, w).contiguous()
    del coeffs
    ref_r = resample(ref, rxx, rxy)
    del rxx, rxy
    src_r = resample(src, *epipolar.apply_h(rect.h_src_inv, *grid))
    corr_r = sweep1d(src_r, ref_r, px)                       # (N, D, H, W, 2)
    del src_r, ref_r, px
    vol = corr_r.permute(0, 2, 3, 1, 4).reshape(n, h, w, dpl * 2)
    del corr_r
    # un-rectify once (depth-independent coords), all D*2 channels at once
    return resample(vol, *epipolar.apply_h(rect.h_ref, *grid))


def aggregate_cost_volume_epipolar(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A cost pass through the rectified 1-D sweep where a pair's geometry
    and fan admit it, the exact 2-D kernel where not (per batch element and
    view).  Eval-time only: raises if an input requires a gradient.

    Args:
      feats: (B, V, H, W, C) channels-last features, view 0 = reference;
        bf16 features are upcast to fp32 first, as the JAX package's entry
        does (its kernels are fp32 end to end).
      proj2: (B, V, 2, 4, 4) stacked cameras.
      depth_values: (B, D) or (B, D, H, W).

    Returns:
      (cost (B, D, H, W, 2) fp32, views summed in order 1..V-1;
       engaged (B, V-1) bool on the CPU: which pairs took the sweep).

    A cost counter counts the whole call as the exact pass it replaces
    (``warp_correlate.counted_pass``).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (feats, proj2, depth_values)):
        raise RuntimeError(
            "the epipolar sweep has no gradient (eval-time only): run it under "
            "torch.no_grad() / inference_mode, or train with warp_impl='cuda'")
    return warp_correlate.counted_pass(
        _epipolar_pass, *warp_correlate.pass_inputs(feats, proj2, depth_values))


def _epipolar_pass(feats: torch.Tensor, rel: torch.Tensor, dv: torch.Tensor):
    """aggregate_cost_volume_epipolar on fp32 (B, V, H, W, C) features,
    (B, V-1, 3, 4) relative projections and (B, D, H, W) hypotheses."""
    b, v, h, w, c = feats.shape
    nv = v - 1
    dpl = dv.shape[1]

    engaged = torch.zeros((b, nv), dtype=torch.bool)
    if _supported(dpl, h, w, c):
        coeffs0, inv_ok, dep_ok = _fan_coeffs(dv)
        rect, (ok, inv_mode) = _host_gates(rel, inv_ok, dep_ok, h, w)
        engaged = ok.reshape(b, nv)
    if not bool(engaged.any()):
        return warp_correlate.warp_correlate(feats, rel, dv), engaged

    pairs = engaged.reshape(-1).nonzero()[:, 0]              # n = b * (V-1) + view - 1
    pb, pv = pairs // nv, pairs % nv
    out = epipolar_corr_pairs(
        feats[pb, pv + 1], feats[pb, 0], rect.select(pairs).to(feats.device),
        coeffs0[pb], inv_mode[pairs].tolist(), dpl)
    del coeffs0

    # views summed in order 1..V-1 per batch element, as the JAX package
    # sums them (an index_add_ would add in any order); a batch element's
    # fallback views go through one call of the exact kernel on that subset
    total = torch.zeros((b, h, w, dpl * 2), dtype=torch.float32, device=feats.device)
    for n, bi in enumerate(pb.tolist()):
        total[bi] += out[n]
    del out
    cost = total.reshape(b, h, w, dpl, 2).permute(0, 3, 1, 2, 4)
    for bi in range(b):
        views = (~engaged[bi]).nonzero()[:, 0].tolist()
        if views:
            cost[bi] += warp_correlate.warp_correlate(
                feats[bi:bi + 1, [0, *(x + 1 for x in views)]].contiguous(),
                rel[bi:bi + 1, views].contiguous(), dv[bi:bi + 1])[0]
    return cost, engaged
