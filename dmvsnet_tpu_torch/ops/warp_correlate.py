"""The fused warp + group-correlation cost pass and its gradient: three
CUDA kernels, their plain PyTorch versions, and the wrappers that pick
between them by device.

Kernels (sources under ``csrc/``, each with a note on what bounds it on an
H100 and what its design does about that):

* ``warp_correlate`` (``warp_correlate.cu``) replaces the TPU kernel
  ``dmvsnet_tpu/ops/pallas/warp_correlate.py:_make_kernel``.  One launch
  covers a whole cost pass: every batch element, source view, plane, pixel.
* ``warp_correlate_grad_ref`` (``warp_correlate_grad_ref.cu``) replaces
  ``_make_grad_ref_kernel``: the adjoint w.r.t. the reference features.
* ``warp_correlate_grad_src`` (``warp_correlate_grad_src.cu``) replaces
  ``_make_grad_src_kernel``: the adjoint w.r.t. the source features, a
  scatter with vector atomics.

All three take the sampling geometry from ``csrc/warp_geometry.cuh``, so
the adjoints see bit for bit the taps and weights of the forward.  The
sampling grid carries no gradient: ``rel`` and ``depth`` get ``None``, as
the JAX package's custom VJP gives them zero cotangents.

The kernels are built at first use with ``nvcc`` (one process per source,
started together) into shared libraries with a plain C interface (no
PyTorch headers, so a build takes seconds), cached under ``build/`` at the
repository root by a hash of source, header and flags, and loaded with
``ctypes``.

The wrappers take the plain versions only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from dmvsnet_tpu_torch.core import geometry
from dmvsnet_tpu_torch.ops import warp

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HEADER = CSRC / "warp_geometry.cuh"
# kernel name -> source file; the C entry point is "dmvs_" + name
SOURCES = {
    "warp_correlate": CSRC / "warp_correlate.cu",
    "warp_correlate_grad_ref": CSRC / "warp_correlate_grad_ref.cu",
    "warp_correlate_grad_src": CSRC / "warp_correlate_grad_src.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CHANNELS = (8, 16, 32)

# Launches per kernel; a wrapper adds one where it launches its kernel and
# nowhere else.  reset_launches() sets every count to 0 to count a run.
LAUNCHES: dict[str, int] = dict.fromkeys(SOURCES, 0)

_fns: dict[str, ctypes._CFuncPtr] = {}
# What the last build() did: seconds, and per kernel the library path,
# whether it was compiled (or found cached) and the ptxas log.
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use on the card")
    return found


def build() -> dict[str, ctypes._CFuncPtr]:
    """Compile (what is not cached) and load the three kernel libraries;
    returns {kernel name: C function}."""
    if _fns:
        return _fns
    t0 = time.perf_counter()
    header = HEADER.read_bytes()
    flags = " ".join(NVCC_FLAGS).encode()
    paths, procs = {}, {}
    for name, src in SOURCES.items():
        tag = hashlib.sha256(src.read_bytes() + header + flags).hexdigest()[:16]
        paths[name] = BUILD_DIR / f"{name}-{tag}.so"
        if not paths[name].exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    fns = {}
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(str(path)), "dmvs_" + name)
        n_ptr = 4 if name == "warp_correlate" else 5
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0,
        kernels={name: dict(path=str(paths[name]), built=name in procs,
                            log=logs.get(name, "")) for name in SOURCES})
    _fns.update(fns)
    return _fns


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
            *rest: torch.Tensor) -> None:
    """Launch kernel ``name`` on CUDA tensors: the three inputs, then the
    kernel's remaining tensors (the output; or the cotangent and the
    gradient buffer).  Raises on what the kernel does not take."""
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, v, h, w, c = feats.shape
    if c not in CHANNELS:
        raise ValueError(f"kernel built for C in {CHANNELS}, got {c}")
    tensors = (feats, rel, depth, *rest)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel tensors must be contiguous")
    if feats.data_ptr() % 16 or rest[-1].data_ptr() % 16:
        raise ValueError("feats and the output must be 16-byte aligned (float4 access)")
    fn = build()[name]
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        LAUNCHES[name] += 1
        err = fn(*(t.data_ptr() for t in tensors), b, v, depth.shape[1], h, w, c, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class _WarpCorrelate(torch.autograd.Function):
    """Kernel 1 forward; backward = the two adjoint kernels.  Saves only the
    inputs and recomputes the geometry in backward."""

    @staticmethod
    def forward(ctx, feats, rel, depth):
        b, _, h, w, _ = feats.shape
        out = torch.empty((b, depth.shape[1], h, w, 2), dtype=torch.float32,
                          device=feats.device)
        _launch("warp_correlate", feats, rel, depth, out)
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
        _launch("warp_correlate_grad_ref", feats, rel, depth, cot, out)
    return out


def warp_correlate_grad_src(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor, cot: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Adjoint w.r.t. the source features: zeroes slots 1.. of the
    (B, V, H, W, C) gradient buffer ``out`` (allocated uninitialised if not
    given) and scatters into them; returns ``out``.  On the card the sums
    are fp32 atomics, so their last bits vary from run to run."""
    _check(feats, rel, depth, cot)
    out = _grad_buffer(feats, out)
    if feats.device.type == "cpu":
        out[:, 1:].copy_(warp_correlate_grad_plain(feats, rel, depth, cot)[:, 1:])
    else:
        out[:, 1:].zero_()
        _launch("warp_correlate_grad_src", feats, rel, depth, cot, out)
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
