"""The fused warp + group-correlation cost pass: CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

The kernel (``csrc/warp_correlate.cu``) replaces the TPU kernel
``dmvsnet_tpu/ops/pallas/warp_correlate.py:_make_kernel``.  One launch
covers a whole cost pass: every batch element, source view, plane and
pixel.  The source note in the ``.cu`` file says what bounds it on an H100
and what its design does about that.

It is built at first use with ``nvcc`` into a shared library with a plain
C interface (no PyTorch headers, so the build takes seconds), cached under
``build/`` at the repository root by a hash of the source and flags, and
loaded with ``ctypes``.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises.  There is no backward yet (the
adjoint kernels are later work), so inputs that require grad under grad
mode raise instead of yielding a result without a gradient.
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

from dmvsnet_tpu_torch.core import geometry
from dmvsnet_tpu_torch.ops import warp

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "warp_correlate.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CHANNELS = (8, 16, 32)

# Kernel launches made by warp_correlate(); the wrapper adds one where it
# launches and nowhere else.  Callers reset it to 0 to count a run.
LAUNCHES = 0

_lib: ctypes.CDLL | None = None
# What the last build() did: library path, seconds, ptxas register report.
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernel "
                           "is built from csrc/ at first use on the card")
    return found


def build() -> ctypes.CDLL:
    """Compile (if not cached) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"warp_correlate-{tag}.so"
    t0 = time.perf_counter()
    log = ""
    built = not lib_path.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.dmvs_warp_correlate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      log=log, built=built)
    _lib = lib
    return lib


def warp_correlate_plain(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract.

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
        warped = warp.bilinear_sample(feats[:, i], px, py)
        corr = warp.group_correlation(warped, ref).float()
        total = corr if total is None else total + corr
    return total


def _check(feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (feats, rel, depth)):
        raise RuntimeError(
            "warp_correlate has no backward yet (ROADMAP §2 kernels 2+3); "
            "call it under torch.no_grad() / torch.inference_mode()"
        )
    if feats.dim() != 5:
        raise ValueError(f"feats must be (B, V, H, W, C), got {tuple(feats.shape)}")
    b, v, h, w, c = feats.shape
    if v < 2:
        raise ValueError("need at least one source view (V >= 2)")
    if tuple(rel.shape) != (b, v - 1, 3, 4):
        raise ValueError(f"rel must be {(b, v - 1, 3, 4)}, got {tuple(rel.shape)}")
    if depth.dim() != 4 or depth.shape[0] != b or tuple(depth.shape[2:]) != (h, w):
        raise ValueError(f"depth must be (B, D, {h}, {w}), got {tuple(depth.shape)}")
    for name, t in (("feats", feats), ("rel", rel), ("depth", depth)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{name} on {t.device}, feats on {feats.device}")


def warp_correlate(
    feats: torch.Tensor, rel: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """The cost pass: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Contract as in warp_correlate_plain."""
    global LAUNCHES
    _check(feats, rel, depth)
    if feats.device.type == "cpu":
        return warp_correlate_plain(feats, rel, depth)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, v, h, w, c = feats.shape
    if c not in CHANNELS:
        raise ValueError(f"kernel built for C in {CHANNELS}, got {c}")
    for name, t in (("feats", feats), ("rel", rel), ("depth", depth)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (float4 loads)")
    d = depth.shape[1]
    lib = build()
    out = torch.empty((b, d, h, w, 2), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        LAUNCHES += 1
        err = lib.dmvs_warp_correlate(
            feats.data_ptr(), rel.data_ptr(), depth.data_ptr(), out.data_ptr(),
            b, v, d, h, w, c, stream,
        )
    if err:
        raise RuntimeError(f"warp_correlate launch failed: cudaError {err}")
    return out


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
      (B, D, H, W, 2) fp32.
    """
    fn = {"cuda": warp_correlate, "torch": warp_correlate_plain}[impl]
    b, _, h, w, _ = feats.shape
    dv = depth_values.float()
    if dv.dim() == 2:
        dv = dv[:, :, None, None].expand(b, dv.shape[1], h, w)
    return fn(feats.float().contiguous(), geometry.relative_projections(proj2),
              dv.contiguous())
