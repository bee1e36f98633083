"""Folded (space-to-depth) execution of the full-resolution level of the
cost U-Nets and of the feature net (port of dmvsnet_tpu.models.folded).

A 2x2 spatial block, and for cost volumes the whole plane axis, is folded
into channels, and each 3x3(x3) convolution of that level runs as ONE
2-D convolution whose kernel is gathered from the canonical parameters.
The arithmetic is the same sums in another order: parameters keep their
canonical shapes and names, so one state dict serves both plans and one
model switches between them (``fold_level0`` of ``FeatureNet``, of the
cost U-Nets and of ``MVSNet``).  There are no folded modules: the
functions below run the existing ``blocks.ConvBlock`` / ``DeconvBlock`` /
``PlainConv`` modules, with their parameters, in folded form.

Layouts (channels first; the channel order is the JAX package's, so a
folded tensor is the JAX one transposed from NHWC to NCHW):

  2-D: (N, C, H, W)    -> (N, 4C, H/2, W/2),    channel (pi, pj, c)
  3-D: (B, C, D, H, W) -> (B, D*4*C, H/2, W/2), channel (d, pi, pj, c)

with (pi, pj) the position inside the 2x2 block.  Tap algebra (rows; the
columns alike; the plane axis is the plain depth band):

  stride 1, folded in / out: out row 2Y'+p' reads in row 2(Y'+u)+p at tap
      kt = 2u + p - p' + k//2
  stride 2, folded in / plain out: out row Y' reads in row 2(Y'+u)+p at tap
      kt = 2u + p + k//2
  transposed k3 s2 (output 2x the input), plain in / folded out: out row
      2Y'+p' sums in[Y'+u] * K[p' - 2u + 1], u in {0, 1}

The port's weights are torch's: ``Conv`` (co, ci, k...) and
``ConvTranspose`` (ci, co, k...), which are flax's kernels (k..., ci, co)
and (k..., co, ci) with the axes permuted and no flip.  A folded kernel is
a torch conv2d weight (cout_f, cin_f, ku, kv): the JAX package's HWIO
kernel transposed.  Its index arrays are built with numpy once per (weight
shape, planes, dims) and kept per device; the only per-call work on the
parameter is one gather and one mask, through which the weight gradient
flows back into the canonical parameter.

Batch norm over a folded tensor has canonical per-channel statistics (over
batch, space and the G fold groups), under the module's own parameters and
buffers: train mode takes the fp32 mean and E[x^2] - E[x]^2 (with a
``process_group``, the synced statistics of ``blocks.group_moments`` over
the same group as the unfolded block), puts the biased variance into the
running statistics with the port's momentum, and returns fp32; a recompute
under remat updates nothing.  Eval mode is the JAX package's folded form:
scale and shift folded in fp32 and applied in the input's dtype (not the
``blocks.py`` form of the unfolded plan, which computes in fp32; the
difference is the JAX package's own).

On the spatial mesh axis (``blocks.spatial_split``, inside
``parallel.spatial.split_rows()``) a folded convolution exchanges one halo
row a side, as the banded convolutions do; one folded row is two image
rows.  The stride-1 3x3 (row padding (1, 1)) uses both, the stride-2 2x2
(padding (1, 0)) the row above, the transposed 2x2 (padding (0, 1)) the row
below.  Bands lie on multiples of 8 rows, so folded bands stay whole.

``stats`` counts the folded convolutions run (``"convolutions"``) and the
calls with ``fold_level0`` set that the shape rule sent to the unfolded
plan (``"declined"``; each one also logged at debug level).

The cost model (``engine/profiler.cost_analysis``) counts the canonical,
unfolded program whatever plan runs: under its counter, ``run`` executes
the folded call with the aten count suspended and the same module's
unfolded execution counted in its place (forward, and in an
``autograd.Function`` the backward too) on copies of the module's buffers,
so the running statistics are the folded call's.  So FLOPs and bytes are equal for both
plans.
"""

from __future__ import annotations

import contextlib
import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F

from dmvsnet_tpu_torch.models import blocks
from dmvsnet_tpu_torch.ops import warp_correlate
from dmvsnet_tpu_torch.parallel import spatial

stats = {"convolutions": 0, "declined": 0}


# ---------------------------------------------------------------- layouts

def fold2d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2), channel (pi, pj, c)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, 4 * c, h // 2, w // 2)


def unfold2d(x: torch.Tensor, c: int) -> torch.Tensor:
    n, _, h2, w2 = x.shape
    x = x.reshape(n, 2, 2, c, h2, w2).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, 2 * h2, 2 * w2)


def fold3d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, D*4*C, H/2, W/2), channel (d, pi, pj, c)."""
    b, c, d, h, w = x.shape
    x = x.reshape(b, c, d, h // 2, 2, w // 2, 2).permute(0, 2, 4, 6, 1, 3, 5)
    return x.reshape(b, d * 4 * c, h // 2, w // 2)


def unfold3d(x: torch.Tensor, d: int, c: int) -> torch.Tensor:
    b, _, h2, w2 = x.shape
    x = x.reshape(b, d, 2, 2, c, h2, w2).permute(0, 4, 1, 5, 2, 6, 3)
    return x.reshape(b, c, d, 2 * h2, 2 * w2)


def fold_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, D*C, H, W), channel (d, c)."""
    b, c, d, h, w = x.shape
    return x.transpose(1, 2).reshape(b, d * c, h, w)


def use_folded_level0(x: torch.Tensor) -> bool:
    """The JAX package's rule for a (B, C, D, H, W) cost volume: fold where
    the folded width D*4*C stays within 128 channels and D, H, W are even
    (at DTU eval the stage-3 main pass, D = 8, and every refine pass,
    D = 4; not stages 1-2's main passes)."""
    _, c, d, h, w = x.shape
    return d * 4 * c <= 128 and d % 2 == 0 and h % 2 == 0 and w % 2 == 0


def decline(what: str, shape) -> None:
    stats["declined"] += 1
    logging.debug("fold_level0: %s of shape %s runs unfolded (the shape rule declines it)",
                  what, tuple(shape))


# ---------------------------------------------------------- folded kernels

def _rows(k: int, folded_out: bool) -> tuple[int, int]:
    """(u0, u1): the block offsets u whose taps land inside a k-tap kernel,
    for a folded (stride 1) or a plain (stride 2) output row."""
    phases = (0, 1) if folded_out else (0,)
    us = [u for u in range(-k, k + 1)
          if any(0 <= 2 * u + p - pp + k // 2 < k for p in (0, 1) for pp in phases)]
    return min(us), max(us)


def _flat(shape, valid, *index) -> np.ndarray:
    """Flat positions in a weight of ``shape`` (clipped where not valid)."""
    clipped = [np.clip(i, 0, n - 1) for i, n in zip(index, shape)]
    return np.where(valid, np.ravel_multi_index(clipped, shape), 0)


@functools.lru_cache(maxsize=None)
def _plan(kind: str, shape: tuple, d: int, dims: int):
    """(flat index, valid mask, padding (lo, hi), planes out) of the folded
    kernel of a weight of ``shape`` (torch layout) with ``d`` planes folded
    into the input (1 for 2-D); ``kind`` "s1", "s2" or "deconv"."""
    if kind == "deconv":
        ci, co = shape[0], shape[1]
        d_out = 2 * d if dims == 3 else 1
        o, a, u, v = np.meshgrid(np.arange(d_out * 4 * co), np.arange(d * ci), np.arange(2),
                                 np.arange(2), indexing="ij")
        md, ci_i = a // ci, a % ci
        od, rest = o // (4 * co), o % (4 * co)
        po, qo, co_i = rest // (2 * co), (rest // co) % 2, rest % co
        kty, ktx = po - 2 * u + 1, qo - 2 * v + 1
        valid = (kty >= 0) & (kty < 3) & (ktx >= 0) & (ktx < 3)
        taps = (kty, ktx)
        if dims == 3:
            ktd = od - 2 * md + 1
            valid &= (ktd >= 0) & (ktd < 3)
            taps = (ktd, kty, ktx)
        return _flat(shape, valid, ci_i, co_i, *taps), valid, (0, 1), d_out
    co, ci, k = shape[0], shape[1], shape[-1]
    u0, u1 = _rows(k, kind == "s1")
    ku = u1 - u0 + 1
    d_out = d if kind == "s1" else ((d + 1) // 2 if dims == 3 else 1)
    cout_f = d_out * 4 * co if kind == "s1" else d_out * co
    o, a, u, v = np.meshgrid(np.arange(cout_f), np.arange(d * 4 * ci), np.arange(ku),
                             np.arange(ku), indexing="ij")
    dd, rest = a // (4 * ci), a % (4 * ci)
    pi, pj, ci_i = rest // (2 * ci), (rest // ci) % 2, rest % ci
    if kind == "s1":
        ddo, rest = o // (4 * co), o % (4 * co)
        po, qo, co_i = rest // (2 * co), (rest // co) % 2, rest % co
        ktd = dd - ddo + 1
    else:
        ddo, co_i = o // co, o % co
        po = qo = 0
        ktd = dd - 2 * ddo + 1
    kty = 2 * (u + u0) + pi - po + k // 2
    ktx = 2 * (v + u0) + pj - qo + k // 2
    valid = (kty >= 0) & (kty < k) & (ktx >= 0) & (ktx < k)
    taps = (kty, ktx)
    if dims == 3:
        valid &= (ktd >= 0) & (ktd < shape[2])
        taps = (ktd, kty, ktx)
    return _flat(shape, valid, co_i, ci_i, *taps), valid, (-u0, u1), d_out


_ON_DEVICE: dict = {}


def _folded_kernel(kind: str, weight: torch.Tensor, d: int, dims: int):
    """(folded conv2d weight, padding (lo, hi), planes out): one gather of
    ``weight`` and one mask."""
    key = (kind, tuple(weight.shape), d, dims)
    flat, valid, pad, d_out = _plan(*key)
    dev_key = key + (str(weight.device),)
    if dev_key not in _ON_DEVICE:
        # normal tensors, even when the first call runs in inference mode:
        # a later call that trains saves the index for its backward
        with torch.inference_mode(False):
            _ON_DEVICE[dev_key] = (torch.from_numpy(flat).to(weight.device),
                                   torch.from_numpy(valid).to(weight.device))
    index, mask = _ON_DEVICE[dev_key]
    return torch.where(mask, weight.reshape(-1)[index], 0.0), pad, d_out


def folded_kernel_s1(weight: torch.Tensor, d: int, dims: int):
    """A stride-1 conv weight (co, ci, k...) -> the folded-in / folded-out
    conv2d weight (d*4*co, d*4*ci, ku, ku) and its padding (lo, hi)."""
    kern, pad, _ = _folded_kernel("s1", weight, d, dims)
    return kern, pad


def folded_kernel_s2(weight: torch.Tensor, d: int, dims: int):
    """A stride-2 conv weight -> the folded-in / plain-out conv2d weight
    (do*co, d*4*ci, ku, ku), its padding and do (the planes out)."""
    return _folded_kernel("s2", weight, d, dims)


def folded_kernel_deconv(weight: torch.Tensor, d_in: int, dims: int):
    """A ConvTranspose(k 3, stride 2, padding 1, output padding 1) weight
    (ci, co, 3...) -> the depth-folded-in / folded-out conv2d weight
    (d_out*4*co, d_in*ci, 2, 2), its padding and d_out."""
    return _folded_kernel("deconv", weight, d_in, dims)


# ------------------------------------------------------ folded execution

def _conv2d(conv, x: torch.Tensor, kern: torch.Tensor, bias, pad) -> torch.Tensor:
    """The folded convolution of ``conv`` (a ``blocks`` conv: its ``spatial``
    mesh): padding (lo, hi) on rows and columns, or on a band of rows the
    halo rows of its neighbours."""
    stats["convolutions"] += 1
    lo, hi = pad
    if conv.spatial is not None and spatial.rows_split():
        n = x.shape[2]
        x = spatial.halo_exchange(x, conv.spatial, 2).narrow(2, 1 - lo, n + lo + hi)
        padding = (0, lo)
        if lo != hi:
            x, padding = F.pad(x, (lo, hi)), (0, 0)
    elif lo == hi:
        padding = (lo, lo)
    else:
        x, padding = F.pad(x, (lo, hi, lo, hi)), (0, 0)
    blocks.note_conv("folded", x, kern, (1, 1), padding)
    return F.conv2d(x, kern, bias, padding=padding)


def _tiled_bias(conv, g: int):
    return None if conv.bias is None else conv.bias.to(conv.compute_dtype).repeat(g)


def batch_norm(bn, x: torch.Tensor, g: int) -> torch.Tensor:
    """``bn`` (a ``blocks`` batch norm over C channels) on a folded
    (N, G*C, h, w) tensor, with canonical per-C statistics."""
    c = bn.num_features
    shape = (1, g * c, 1, 1)
    if not (bn.training and bn.track_running_stats):
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * inv
        return (x * inv.repeat(g).to(x.dtype).view(shape)
                + shift.repeat(g).to(x.dtype).view(shape))
    n, _, h, w = x.shape
    xf = x.float()
    xr = xf.view(n, g, c, h, w)
    dims = (0, 1, 3, 4)
    if bn.process_group is not None:
        mean, var = blocks.group_moments(xr, dims, (1, 1, c, 1, 1), bn.process_group)
    else:
        mean = xr.mean(dims)
        var = xr.square().mean(dims) - mean.square()
    if not blocks.recomputing():
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
            bn.num_batches_tracked += 1
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    return ((xf - mean.repeat(g).view(shape)) * inv.repeat(g).view(shape)
            + bn.bias.repeat(g).view(shape))


def conv_block(block, x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """``block`` (a ``blocks.ConvBlock``) on ``x`` folded with ``d`` planes
    (1 for 2-D).  Stride 1: folded out; stride 2: plain out."""
    conv = block.conv
    dims, dt = conv.weight.dim() - 2, conv.compute_dtype
    x = x.to(dt)
    w = conv.weight.to(dt)
    if conv.stride[-1] == 1:
        kern, pad = folded_kernel_s1(w, d, dims)
        g = d * 4
        y = _conv2d(conv, x, kern, _tiled_bias(conv, g), pad)
        if block.bn is not None:
            y = batch_norm(block.bn, y, g)
    else:
        kern, pad, do = folded_kernel_s2(w, d, dims)
        y = _conv2d(conv, x, kern, _tiled_bias(conv, do), pad)
        if dims == 3:
            n, _, h2, w2 = y.shape
            y = y.view(n, do, w.shape[0], h2, w2).transpose(1, 2)
        if block.bn is not None:
            y = block.bn(y.float())
            if not block.training:
                y = y.to(block.dtype)
    return torch.relu(y) if block.relu else y


def deconv_block(block, x: torch.Tensor, d_in: int = 1) -> torch.Tensor:
    """``block`` (a ``blocks.DeconvBlock``) on plain ``x`` with ``d_in``
    planes (1 for 2-D): folded out, with 2 * d_in planes."""
    conv = block.conv
    dims, dt = conv.weight.dim() - 2, conv.compute_dtype
    if dims == 3:
        x = fold_depth(x)
    kern, pad, d_out = folded_kernel_deconv(conv.weight.to(dt), d_in, dims)
    g = d_out * 4
    y = _conv2d(conv, x.to(dt), kern, _tiled_bias(conv, g), pad)
    if block.bn is not None:
        y = batch_norm(block.bn, y, g)
    return torch.relu(y) if block.relu else y


def plain_conv(conv, x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """``conv`` (a ``blocks.PlainConv``, stride 1) on ``x`` folded with
    ``d`` planes: folded out."""
    dims, dt = conv.weight.dim() - 2, conv.compute_dtype
    kern, pad = folded_kernel_s1(conv.weight.to(dt), d, dims)
    return _conv2d(conv, x.to(dt), kern, _tiled_bias(conv, d * 4), pad)


# ------------------------------------------------------------ cost model

@contextlib.contextmanager
def _on_copies(module, counter):
    """Within the block (in train mode) ``module``'s buffers are copies, so
    the counted unfolded call leaves the running statistics of the folded
    call alone (and no tensor that a graph saved changes in place)."""
    saved = {}
    if module.training:
        with counter.suspend():
            for m in module.modules():
                for name, b in m._buffers.items():
                    if b is not None:
                        saved[m, name] = b
                        m._buffers[name] = b.clone()
    try:
        yield
    finally:
        for (m, name), b in saved.items():
            m._buffers[name] = b


def run(module, folded_fn, unfolded_fn, x: torch.Tensor):
    """``folded_fn(x)``, the folded execution of ``module`` (a tensor or a
    tuple of tensors).  Under the cost counter (``ops/warp_correlate.COUNTER``)
    it runs with the aten count suspended and ``unfolded_fn(x)``, the
    module's unfolded execution, is counted in its place; where a gradient
    is needed, its backward too."""
    counter = warp_correlate.COUNTER
    if counter is None:
        return folded_fn(x)
    params = list(module.parameters())
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        ys = _CountedFold.apply(folded_fn, unfolded_fn, counter, module, x, *params)
        return ys[0] if len(ys) == 1 else ys
    with counter.suspend():
        y = folded_fn(x)
    with _on_copies(module, counter):
        unfolded_fn(x)
    return y


def _tuple(y) -> tuple:
    return y if isinstance(y, tuple) else (y,)


class _CountedFold(torch.autograd.Function):
    """A folded call under the cost counter that needs a gradient: forward
    and backward run the folded graph with the count suspended and the
    unfolded graph of the same parameters counted."""

    @staticmethod
    def forward(ctx, folded_fn, unfolded_fn, counter, module, x, *params):
        with torch.enable_grad():
            with counter.suspend():
                xf = x.detach().requires_grad_(x.requires_grad)
                ys = _tuple(folded_fn(xf))
                xu = x.detach().requires_grad_(x.requires_grad)
            with _on_copies(module, counter):
                yus = _tuple(unfolded_fn(xu))
        ctx.graphs = (xf, ys, xu, yus, params, counter)
        return tuple(y.detach() for y in ys)

    @staticmethod
    def backward(ctx, *gys):
        xf, ys, xu, yus, params, counter = ctx.graphs
        del ctx.graphs
        wrt = [i for i, t in enumerate((xf, *params)) if t.requires_grad]
        with counter.suspend():
            got = torch.autograd.grad(ys, [(xf, *params)[i] for i in wrt], gys,
                                      allow_unused=True)
        torch.autograd.grad(yus, [(xu, *params)[i] for i in wrt], gys, allow_unused=True)
        grads = [None] * (1 + len(params))
        for i, g in zip(wrt, got):
            grads[i] = g
        return (None, None, None, None, *grads)


def set_fold_level0(module, on: bool) -> None:
    """Sets ``fold_level0`` on every submodule of ``module`` that has one
    (the feature net and the cost U-Net branches)."""
    for m in module.modules():
        if hasattr(m, "fold_level0"):
            m.fold_level0 = bool(on)
