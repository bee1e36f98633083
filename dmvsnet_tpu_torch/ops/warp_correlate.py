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
  ``_make_grad_ref_kernel``: the adjoint w.r.t. the reference features, a
  gather whose lane groups share the geometry as the forward's do.
* ``warp_correlate_grad_src`` (``warp_correlate_grad_src.cu``) replaces
  ``_make_grad_src_kernel``: the adjoint w.r.t. the source features, a
  scatter that sums a pixel's consecutive planes in registers while they
  share a bilinear cell, before its atomic adds reach device memory.
* ``gated_warp_correlate`` (``warp_correlate_gated.cu``) replaces no TPU
  kernel: the adaptive cost pass of one (stage, pass) in one launch, each
  source view's correlation gated by the weight net's folded eval form and
  summed in registers (``aggregate_cost_volume_gated``).  Forward only.

All four take the sampling geometry from ``csrc/warp_geometry.cuh``, so
the adjoints see bit for bit the taps and weights of the forward.  The
sampling grid carries no gradient: ``rel`` and ``depth`` get ``None``, as
the JAX package's custom VJP gives them zero cotangents.

The kernels are declared here and built at first use by
``ops/cuda_build.py`` (``nvcc`` into plain-C shared libraries under
``build/``, loaded with ``ctypes``).

The wrappers take the plain versions only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises.

Every cost pass of the model goes through ``counted_pass``: while a cost
counter is active (``COUNTER``, installed by
``engine/profiler.cost_analysis``) the pass reports one canonical count,
``pass_cost`` forward and ``adjoint_cost`` with every tap backward, whatever
computes it (kernel or plain version, the epipolar sweep, one call per view
pair), and the aten ops inside it are not counted on top.  The gated pass
does not: the model takes it only while no counter is active.

The kernels are fp32 end to end.  The cost-pass entries
(``aggregate_cost_volume``, its view-sharded, adaptive and pixel-wise
forms) upcast bf16 features to fp32 before the kernel, as the JAX
package's Pallas entries do (``dmvsnet_tpu/ops/pallas/warp_correlate.py``,
``aggregate_cost_volume_pallas``): the cost volume is fp32, and autograd
returns the feature gradient through the upcast in the caller's dtype.
"""

from __future__ import annotations

import threading

import torch
from torch.autograd.function import once_differentiable

from dmvsnet_tpu_torch.core import geometry
from dmvsnet_tpu_torch.ops import cuda_build, warp
from dmvsnet_tpu_torch.parallel.mesh import AXIS_VIEW

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
    "gated_warp_correlate": ("warp_correlate_gated.cu", cuda_build.pointer_ints(5, 6),
                             _GEOMETRY),
})

# adaptive cost passes by route since the last reset: "gated", one launch
# of the gated pass (aggregate_cost_volume_gated); "per_pair", a pass run
# pair by pair (aggregate_cost_volume_adaptive)
_ADAPTIVE_STATS = {"gated": 0, "per_pair": 0}
_ADAPTIVE_STATS_LOCK = threading.Lock()


def adaptive_stats() -> dict[str, int]:
    """Adaptive cost passes since the last reset, by route: ``gated`` and
    ``per_pair``."""
    with _ADAPTIVE_STATS_LOCK:
        return dict(_ADAPTIVE_STATS)


def reset_adaptive_stats() -> None:
    with _ADAPTIVE_STATS_LOCK:
        for k in _ADAPTIVE_STATS:
            _ADAPTIVE_STATS[k] = 0


def _count_adaptive(route: str) -> None:
    with _ADAPTIVE_STATS_LOCK:
        _ADAPTIVE_STATS[route] += 1


# The active cost counter, or None: an object with ``add(kind, nbytes,
# flops)`` and a context manager ``suspend()`` inside which it counts no aten op
# (engine/profiler.cost_analysis installs one for the call it counts).
COUNTER = None


def pass_cost(b: int, v: int, d: int, h: int, w: int, c: int) -> tuple[int, int]:
    """Least bytes (each input read once, the output written once) and fp32
    operations (10*C + 20 per pixel, plane and source view) of one cost pass
    on (B, V, H, W, C) features and D planes."""
    nbytes = 4 * (b * d * h * w + b * d * h * w * 2 + b * v * h * w * c + b * (v - 1) * 12)
    flops = b * d * h * w * (v - 1) * (10 * c + 20)
    return nbytes, flops


def adjoint_cost(b: int, v: int, d: int, h: int, w: int, c: int,
                 taps: int | None = None) -> dict[str, tuple[int, int]]:
    """Least bytes and fp32 operations of each adjoint kernel for one pass.
    Both read depth and the cotangent pair and the projections once.
    grad_ref: reads the source features, writes the reference gradient;
    8*C + 20 operations per (pixel, plane, view) (4 taps x C multiply-adds,
    the geometry) and 2*C per (pixel, plane) for the cotangent.
    grad_src: reads the reference features, writes the source gradient;
    2*C operations per (pixel, plane), 20 per (pixel, plane, view) and 2*C
    per tap added.  ``taps`` is the taps with a nonzero weight that given
    inputs really add; None counts every tap, 4 per (pixel, plane, source
    view), which is what the plain version computes and what a cost
    counter counts."""
    if taps is None:
        taps = 4 * b * d * h * w * (v - 1)
    shared = b * d * h * w * 3 + b * (v - 1) * 12
    return {
        "warp_correlate_grad_ref": (
            4 * (shared + b * (v - 1) * h * w * c + b * h * w * c),
            b * d * h * w * ((v - 1) * (8 * c + 20) + 2 * c)),
        "warp_correlate_grad_src": (
            4 * (shared + b * h * w * c + b * (v - 1) * h * w * c),
            b * d * h * w * (2 * c + (v - 1) * 20) + taps * 2 * c),
    }


def _pass_shape(feats: torch.Tensor, depth: torch.Tensor) -> tuple[int, ...]:
    b, v, h, w, c = feats.shape
    return b, v, depth.shape[1], h, w, c


def counted_pass(fn, feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor):
    """``fn(feats, rel, depth)``: one cost pass on (B, V, H, W, C) fp32
    features, (B, V-1, 3, 4) projections and (B, D, H, W) hypotheses.  With
    no active counter that is all it does.  Under one, the pass runs with
    the counter suspended and reports ``pass_cost`` once; where ``feats``
    needs a gradient its backward (``warp_correlate_grad``, or
    ``warp_correlate_grad_plain`` when ``fn`` is the plain version) reports
    both ``adjoint_cost``s with every tap."""
    counter = COUNTER
    if counter is None:
        return fn(feats, rel, depth)
    if torch.is_grad_enabled() and feats.requires_grad:
        return _CountedPass.apply(fn, counter, feats, rel, depth)
    with counter.suspend():
        out = fn(feats, rel, depth)
    counter.add("cost_pass", *pass_cost(*_pass_shape(feats, depth)))
    return out


class _CountedPass(torch.autograd.Function):
    """A counted cost pass whose features need a gradient: forward and
    backward each run the pass's own code with the counter suspended and
    report their count once."""

    @staticmethod
    def forward(ctx, fn, counter, feats, rel, depth):
        with counter.suspend():
            out = fn(feats, rel, depth)
        counter.add("cost_pass", *pass_cost(*_pass_shape(feats, depth)))
        ctx.fn, ctx.counter = fn, counter
        ctx.save_for_backward(feats, rel, depth)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        feats, rel, depth = ctx.saved_tensors
        grad_fn = warp_correlate_grad_plain if ctx.fn is warp_correlate_plain else warp_correlate_grad
        with ctx.counter.suspend():
            grad = grad_fn(feats, rel, depth, cot.contiguous())
        for cost in adjoint_cost(*_pass_shape(feats, depth)).values():
            ctx.counter.add("cost_pass_adjoint", *cost)
        return None, None, grad, None, None


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


def _check_tap_code(h: int, w: int) -> None:
    """Kernels 1 and 3 pass a tap's pixel index shifted left by 2 between
    lanes in an int: refuse H*W >= 2^29 before anything is allocated."""
    if h * w >= 1 << 29:
        raise ValueError(f"{h}x{w} pixels: the kernel packs a tap's pixel index in 29 bits")


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
        _check_tap_code(h, w)
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


def gated_warp_correlate_plain(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, gate: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the gated pass, same contract.

    Args:
      feats, rel, depth: as in warp_correlate_plain.
      gate: (5,) fp32 ``w00, w01, b0, a1, b1``, the weight net's two 1x1x1
        blocks (2 -> 1 -> 1 channels) with their eval norms folded in
        (``models/cost_reg.AggWeightNetVolume.gate_params``).

    Returns:
      (B, D, H, W, 2) fp32: per source view v, its pair's correlation c_v
      (``warp_correlate_plain`` on the pair) times
      ``1 / (1 + exp(-relu(a1 * relu(w00 c_v0 + w01 c_v1 + b0) + b1)))``,
      summed in view order.
    """
    w00, w01, b0, a1, b1 = gate.unbind()
    total = None
    for i in range(1, feats.shape[1]):
        corr = warp_correlate_plain(feats[:, [0, i]], rel[:, i - 1:i], depth)
        c0, c1 = corr.unbind(-1)
        h = torch.relu(w00 * c0 + w01 * c1 + b0)
        s = 1.0 / (1.0 + torch.exp(-torch.relu(a1 * h + b1)))
        gated = corr * s[..., None]
        total = gated if total is None else total + gated
    return total


def gated_warp_correlate(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, gate: torch.Tensor
) -> torch.Tensor:
    """The gated pass: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Contract as in gated_warp_correlate_plain.  The kernel
    has no adjoint, so on the card it refuses inputs that need a
    gradient."""
    _check(feats, rel, depth)
    if tuple(gate.shape) != (5,) or gate.dtype != torch.float32 or gate.device != feats.device:
        raise ValueError(f"gate must be a (5,) float32 tensor on {feats.device}, got "
                         f"{tuple(gate.shape)} {gate.dtype} on {gate.device}")
    if feats.device.type == "cpu":
        return gated_warp_correlate_plain(feats, rel, depth, gate)
    if torch.is_grad_enabled() and (feats.requires_grad or gate.requires_grad):
        raise ValueError("the gated pass has no adjoint: run it with autograd off")
    b, _, h, w, _ = feats.shape
    _check_tap_code(h, w)
    out = torch.empty((b, depth.shape[1], h, w, 2), dtype=torch.float32, device=feats.device)
    _launch("gated_warp_correlate", feats, rel, depth, gate, out, out=out)
    return out


def warp_correlate_grad_ref(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint w.r.t. the reference features, written into slot 0 of the
    (B, V, H, W, C) gradient buffer ``out`` (allocated uninitialised if not
    given); returns ``out``.  Contract as in warp_correlate_grad_plain."""
    _check(feats, rel, depth, cot)
    if feats.device.type != "cpu":
        _check_tap_code(*feats.shape[2:4])
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
    return counted_pass(fn, *pass_inputs(feats, proj2, depth_values))


def pass_inputs(feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor):
    """fp32 contiguous features (upcast from bf16), relative projections,
    (B, D, H, W) hypotheses."""
    b, _, h, w, _ = feats.shape
    dv = depth_values.float()
    if dv.dim() == 2:
        dv = dv[:, :, None, None].expand(b, dv.shape[1], h, w)
    return (feats.float().contiguous(), geometry.relative_projections(proj2),
            dv.contiguous())


def aggregate_cost_volume_adaptive(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor, gate_fn,
    impl: str = "cuda",
) -> torch.Tensor:
    """The adaptive cost pass pair by pair (port of
    ``dmvsnet_tpu.ops.warp.aggregate_cost_volume_adaptive``): per source
    view v, kernel 1 on the (reference, source v) pair (a launch with V = 2;
    its backward the two adjoint kernels on that pair), gated by
    ``gate_fn`` and summed in view order (``adaptive_pairs``).
    ``impl="torch"``, or CPU tensors, take the plain version per pair.
    Counts one ``per_pair`` pass in ``adaptive_stats``.

    Args: as ``aggregate_cost_volume``, plus ``gate_fn``: one pair's
    (B, D, H, W, 2) fp32 correlation -> the gated (B, D, H, W, 2) fp32
    correlation, ``corr * sigmoid(weight net(corr))`` in the model.

    Returns:
      (B, D, H, W, 2) fp32.  Differentiable w.r.t. ``feats`` and whatever
      ``gate_fn`` holds.
    """
    _count_adaptive("per_pair")
    return adaptive_pairs(*pass_inputs(feats, proj2, depth_values), gate_fn, impl)


def pair_passes(feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor,
                impl: str = "cuda"):
    """The one per-pair loop of the cost passes: on a pass's inputs
    (``pass_inputs``), yields in view order each (reference, source v)
    pair's (B, D, H, W, 2) fp32 correlation, one counted pass at V = 2
    (``counted_pass``; kernel 1, or its plain version for ``impl="torch"``
    and CPU tensors)."""
    fn = {"cuda": warp_correlate, "torch": warp_correlate_plain}[impl]
    for i in range(1, feats.shape[1]):
        yield counted_pass(fn, feats[:, [0, i]], rel[:, i - 1:i].contiguous(), depth)


def adaptive_pairs(feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, gate_fn,
                   impl: str = "cuda") -> torch.Tensor:
    """The per-pair route of ``aggregate_cost_volume_adaptive`` on a pass's
    inputs (``pass_inputs``): each pair gated by ``gate_fn``, summed in view
    order."""
    total = None
    for corr in pair_passes(feats, rel, depth, impl):
        corr = gate_fn(corr)
        total = corr if total is None else total + corr
    return total


def aggregate_cost_volume_pixelwise(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor, weight_fn,
    impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """TransMVSNet's cost pass (``models/transmvsnet``): per source view i,
    its pair's one-group similarity S_i, the mean of the pair's two group
    correlations (the mean over channels of warped * reference), weighted
    per pixel by ``weight_fn(i, S_i)``, a (B, H, W) weight w_i.

    Args: as ``aggregate_cost_volume``, plus ``weight_fn``.

    Returns:
      ((B, D, H, W) fp32 sum_i w_i S_i / (sum_i w_i + 1e-5), summed in view
      order; the (B, V-1, H, W) weights).
    """
    total = weight_sum = None
    weights = []
    for i, corr in enumerate(pair_passes(*pass_inputs(feats, proj2, depth_values), impl)):
        sim = corr.mean(-1)
        w = weight_fn(i, sim)
        weighted = sim * w[:, None]
        total = weighted if total is None else total + weighted
        weight_sum = w if weight_sum is None else weight_sum + w
        weights.append(w)
    return total / (weight_sum + 1e-5)[:, None], torch.stack(weights, 1)


def aggregate_cost_volume_gated(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor, gate: torch.Tensor,
    impl: str = "cuda",
) -> torch.Tensor:
    """The adaptive cost pass in one gated pass: for a weight net whose
    eval norms fold into its convolutions (``gate``, as in
    ``gated_warp_correlate_plain``), what ``aggregate_cost_volume_adaptive``
    computes with ``MVSNet._gate``, up to rounding.  Relative projections
    in fp32 torch, then the gated kernel (``impl="cuda"``, which runs the
    plain version on CPU tensors) or the plain version (``impl="torch"``).
    Forward only, and not seen by a cost counter: the model takes it only
    with autograd off and no count running.  Counts one ``gated`` pass in
    ``adaptive_stats``."""
    fn = {"cuda": gated_warp_correlate, "torch": gated_warp_correlate_plain}[impl]
    _count_adaptive("gated")
    return fn(*pass_inputs(feats, proj2, depth_values), gate)


def aggregate_cost_volume_view_sharded(
    feats: torch.Tensor, proj2: torch.Tensor, depth_values: torch.Tensor, mesh,
    impl: str = "cuda",
) -> torch.Tensor:
    """``aggregate_cost_volume`` with the V-1 source views sharded over the
    mesh's vp axis (port of ``dmvsnet_tpu.ops.warp.aggregate_cost_volume_view_sharded``).

    vp rank r runs the cost pass on the reference view and its source views
    1 + r*k .. (r+1)*k, k = (V-1)/vp (one kernel launch over 1+k views), and
    one all_reduce over the vp group sums the partial cost volumes.  The
    view sum is associative, so this is the serial result up to fp
    reassociation.  The all_reduce's backward sums the cotangents over the
    group (``parallel.mesh.psum``): each rank's feature gradient is vp times
    that of its own views, and DDP's mean over the ranks divides it back.

    Args: as ``aggregate_cost_volume``, plus ``mesh``, a ``parallel.Mesh``
    whose vp size divides V-1 (raises ValueError otherwise).
    """
    v1, vp = feats.shape[1] - 1, mesh.size(AXIS_VIEW)
    if v1 % vp:
        raise ValueError(f"vp={vp} must divide the {v1} source views")
    k = v1 // vp
    mine = [0, *range(1 + mesh.coords[AXIS_VIEW] * k, 1 + (mesh.coords[AXIS_VIEW] + 1) * k)]
    partial = aggregate_cost_volume(feats[:, mine], proj2[:, mine], depth_values, impl)
    return mesh.psum(partial, AXIS_VIEW, "view_sum")
