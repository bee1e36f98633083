"""The fused warp + group-correlation cost pass and its gradient: three
CUDA kernels, their plain PyTorch versions, and the wrappers that pick
between them by device.

Kernels (sources under ``csrc/``, each with a note on what bounds it on an
H100 and what its design does about that):

* ``warp_correlate`` (``warp_correlate.cu``) replaces the TPU kernel
  ``dmvsnet_tpu/ops/pallas/warp_correlate.py:_make_kernel``.  One launch
  covers a whole cost pass: every batch element, source view, plane, pixel;
  a sample's channels lie on consecutive lanes, each lane group serves a
  few planes.
* ``warp_correlate_grad_ref`` (``warp_correlate_grad_ref.cu``) replaces
  ``_make_grad_ref_kernel``: the adjoint w.r.t. the reference features.
* ``warp_correlate_grad_src`` (``warp_correlate_grad_src.cu``) replaces
  ``_make_grad_src_kernel``: the adjoint w.r.t. the source features, a
  scatter that sums a pixel's consecutive planes in registers while they
  share a bilinear cell, before its atomic adds reach device memory.

All three take the sampling geometry from ``csrc/warp_geometry.cuh``, so
the adjoints see bit for bit the taps and weights of the forward.  The
sampling grid carries no gradient: ``rel`` and ``depth`` get ``None``, as
the JAX package's custom VJP gives them zero cotangents.

The kernels are declared here and built at first use by
``ops/cuda_build.py`` (``nvcc`` into plain-C shared libraries under
``build/``, loaded with ``ctypes``).

The wrappers take the plain versions only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dmvsnet_tpu_torch.core import geometry
from dmvsnet_tpu_torch.ops import cuda_build, warp

CHANNELS = (8, 16, 32)

# kernel name -> (source, C arguments): feats, rel, depth and the kernel's
# remaining tensors (the scatter's last one its counters, NULL when not
# asked for), then B, V, D, H, W, C and the stream.  LAUNCHES counts
# launches per kernel; a wrapper adds one where it launches its kernel and
# nowhere else (cuda_build.reset_launches() sets every count to 0).
_GEOMETRY = ("warp_geometry.cuh",)
LAUNCHES: dict[str, int] = cuda_build.declare({
    "warp_correlate": ("warp_correlate.cu", cuda_build.pointer_ints(4, 6), _GEOMETRY),
    "warp_correlate_grad_ref": ("warp_correlate_grad_ref.cu", cuda_build.pointer_ints(5, 6),
                                _GEOMETRY),
    "warp_correlate_grad_src": ("warp_correlate_grad_src.cu", cuda_build.pointer_ints(6, 6),
                                _GEOMETRY),
})


def warp_correlate_plain(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, same contract.

    Differentiated by autograd it is also the plain version of both adjoint
    kernels: the sampling coordinates are detached, so ``rel`` and ``depth``
    receive no gradient (as in the JAX package, whose warp stops the
    gradient at px/py).

    Args:
      feats: (B, V, H, W, C) features, view 0 = reference.
      rel: (B, V-1, 3, 4) relative projections of the source views.
      depth: (B, D, H, W) hypotheses.

    Returns:
      (B, D, H, W, 2) fp32 cost volume, views summed in order 1..V-1.
    """
    _, v, h, w, _ = feats.shape
    ref = feats[:, 0]
    total = None
    for i in range(1, v):
        px, py = geometry.plane_sweep_coords(rel[:, i - 1], depth, h, w)
        warped = warp.bilinear_sample(feats[:, i], px.detach(), py.detach())
        corr = warp.group_correlation(warped, ref).float()
        total = corr if total is None else total + corr
    return total


def warp_correlate_grad_plain(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the two adjoint kernels together: autograd
    of ``warp_correlate_plain`` w.r.t. ``feats`` against the cotangent.

    Args:
      feats, rel, depth: as in warp_correlate_plain.
      cot: (B, D, H, W, 2) cotangent of the cost volume.

    Returns:
      (B, V, H, W, C) gradient of ``feats``: slot 0 is what
      warp_correlate_grad_ref computes, slots 1.. what
      warp_correlate_grad_src computes.
    """
    with torch.enable_grad():
        f = feats.detach().requires_grad_()
        out = warp_correlate_plain(f, rel.detach(), depth.detach())
        (grad,) = torch.autograd.grad(out, f, cot)
    return grad


def _check(feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor,
           cot: torch.Tensor | None = None) -> None:
    if feats.dim() != 5:
        raise ValueError(f"feats must be (B, V, H, W, C), got {tuple(feats.shape)}")
    b, v, h, w, c = feats.shape
    if v < 2:
        raise ValueError("need at least one source view (V >= 2)")
    if tuple(rel.shape) != (b, v - 1, 3, 4):
        raise ValueError(f"rel must be {(b, v - 1, 3, 4)}, got {tuple(rel.shape)}")
    if depth.dim() != 4 or depth.shape[0] != b or tuple(depth.shape[2:]) != (h, w):
        raise ValueError(f"depth must be (B, D, {h}, {w}), got {tuple(depth.shape)}")
    tensors = [("feats", feats), ("rel", rel), ("depth", depth)]
    if cot is not None:
        if tuple(cot.shape) != (*depth.shape, 2):
            raise ValueError(f"cot must be {(*depth.shape, 2)}, got {tuple(cot.shape)}")
        tensors.append(("cot", cot))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{name} on {t.device}, feats on {feats.device}")


def _grad_buffer(feats: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """The (B, V, H, W, C) gradient buffer: ``out`` if it fits ``feats``,
    else a new uninitialised one."""
    if out is None:
        return torch.empty_like(feats)
    if out.shape != feats.shape or out.dtype != feats.dtype or out.device != feats.device:
        raise ValueError(f"out must match feats: {tuple(feats.shape)} {feats.dtype} on "
                         f"{feats.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    return out


def _launch(name: str, feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor,
            *rest: torch.Tensor | None, out: torch.Tensor) -> None:
    """Launch kernel ``name`` on CUDA tensors: the three inputs, then the
    kernel's remaining tensors (the output; or the cotangent and the
    gradient buffer ``out``, and the scatter's counters or None).  Raises on
    what the kernel does not take."""
    b, v, h, w, c = feats.shape
    if c not in CHANNELS:
        raise ValueError(f"kernel built for C in {CHANNELS}, got {c}")
    if feats.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("feats and the output must be 16-byte aligned (float4 access)")
    cuda_build.launch(name, (feats, rel, depth, *rest), (b, v, depth.shape[1], h, w, c))


class _WarpCorrelate(torch.autograd.Function):
    """Kernel 1 forward; backward = the two adjoint kernels.  Saves only the
    inputs and recomputes the geometry in backward."""

    @staticmethod
    def forward(ctx, feats, rel, depth):
        b, _, h, w, _ = feats.shape
        if h * w >= 1 << 29:
            raise ValueError(f"{h}x{w} pixels: the kernel packs a tap's pixel index in 29 bits")
        out = torch.empty((b, depth.shape[1], h, w, 2), dtype=torch.float32,
                          device=feats.device)
        _launch("warp_correlate", feats, rel, depth, out, out=out)
        ctx.save_for_backward(feats, rel, depth)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        feats, rel, depth = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = warp_correlate_grad(feats, rel, depth, cot.contiguous())
        return grad, None, None


def warp_correlate(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """The cost pass: the CUDA kernels (forward, and both adjoints when a
    gradient is asked for) for CUDA tensors, the plain version under
    ordinary autograd for CPU tensors.  Contract as in
    warp_correlate_plain; ``rel`` and ``depth`` get no gradient."""
    _check(feats, rel, depth)
    if feats.device.type == "cpu":
        return warp_correlate_plain(feats, rel, depth)
    return _WarpCorrelate.apply(feats, rel, depth)


def warp_correlate_grad_ref(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint w.r.t. the reference features, written into slot 0 of the
    (B, V, H, W, C) gradient buffer ``out`` (allocated uninitialised if not
    given); returns ``out``.  Contract as in warp_correlate_grad_plain."""
    _check(feats, rel, depth, cot)
    out = _grad_buffer(feats, out)
    if feats.device.type == "cpu":
        out[:, 0].copy_(warp_correlate_grad_plain(feats, rel, depth, cot)[:, 0])
    else:
        _launch("warp_correlate_grad_ref", feats, rel, depth, cot, out, out=out)
    return out


def warp_correlate_grad_src(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor,
    out: torch.Tensor | None = None, stats: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint w.r.t. the source features: zeroes slots 1.. of the
    (B, V, H, W, C) gradient buffer ``out`` (allocated uninitialised if not
    given) and scatters into them; returns ``out``.  On the card the sums
    are fp32 atomics, so their last bits vary from run to run.

    ``stats``, a (2,) int64 tensor on the same device, receives what a
    launch did (added to its entries): the float4 atomic adds it issued to
    device memory, and the times a lane's bilinear cell changed from one
    plane to the next.  Not given, nothing is counted; CPU tensors count
    nothing."""
    _check(feats, rel, depth, cot)
    out = _grad_buffer(feats, out)
    if stats is not None and (stats.shape != (2,) or stats.dtype != torch.int64
                              or stats.device != feats.device):
        raise ValueError(f"stats must be a (2,) int64 tensor on {feats.device}")
    if feats.device.type == "cpu":
        out[:, 1:].copy_(warp_correlate_grad_plain(feats, rel, depth, cot)[:, 1:])
    else:
        out[:, 1:].zero_()
        _launch("warp_correlate_grad_src", feats, rel, depth, cot, out, stats, out=out)
    return out


def warp_correlate_grad(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor
) -> torch.Tensor:
    """Gradient of the cost pass w.r.t. ``feats``: both adjoint kernels on
    CUDA tensors, the plain version on CPU tensors."""
    _check(feats, rel, depth, cot)
    if feats.device.type == "cpu":
        return warp_correlate_grad_plain(feats, rel, depth, cot)
    out = torch.empty_like(feats)
    warp_correlate_grad_ref(feats, rel, depth, cot, out)
    return warp_correlate_grad_src(feats, rel, depth, cot, out)


def aggregate_cost_volume(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor,
    impl: str = "cuda",
) -> torch.Tensor:
    """A cost pass from cameras: relative projections in fp32 torch, then
    the kernel (``impl="cuda"``, which runs the plain version on CPU
    tensors) or the plain version (``impl="torch"``).

    Args:
      feats: (B, V, H, W, C) channels-last features, view 0 = reference.
      proj2: (B, V, 2, 4, 4) stacked cameras.
      depth_values: (B, D) or (B, D, H, W).

    Returns:
      (B, D, H, W, 2) fp32.  Differentiable w.r.t. ``feats`` only.
    """
    fn = {"cuda": warp_correlate, "torch": warp_correlate_plain}[impl]
    b, _, h, w, _ = feats.shape
    dv = depth_values.float()
    if dv.dim() == 2:
        dv = dv[:, :, None, None].expand(b, dv.shape[1], h, w)
    return fn(feats.float().contiguous(), geometry.relative_projections(proj2),
              dv.contiguous())
