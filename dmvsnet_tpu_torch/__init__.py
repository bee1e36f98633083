"""dmvsnet_tpu_torch — the PyTorch / CUDA port of dmvsnet_tpu for NVIDIA Hopper.

The JAX package ``dmvsnet_tpu`` is the reference: every module here mirrors
its counterpart's name and contract and is tested against it on the CPU.
This package imports neither JAX nor any module of ``dmvsnet_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without CUDA a CUDA request raises instead of carrying on
on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises RuntimeError for a CUDA device on a machine without CUDA.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def pin_fp32() -> None:
    """Full-fp32 convolutions and matmuls on the card.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits); the port is held to the fp32 JAX reference, so the entry
    points switch TF32 off for both cuDNN and cuBLAS.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# how many convolution algorithms cuDNN times for each new problem, its
# heuristic's first ones (``torch.backends.cudnn.benchmark_limit``).  On an
# H100 the third holds the fast kernels of the port's 3-D transposed
# convolutions, and every one more costs set-up time in the first step of a
# shape.  A backward searches each problem's data and weight gradients:
# there the third candidate cost more set-up than its gain of a training
# step is worth, so a backward times two (PERF.md §6).
CONV_CANDIDATES = 3
BACKWARD_CONV_CANDIDATES = 2


@contextlib.contextmanager
def measured_conv_algorithms(candidates: int):
    """cuDNN chooses each convolution's algorithm by measurement inside the
    block (``torch.backends.cudnn.benchmark``), among its first
    ``candidates``.

    By its heuristic cuDNN runs the port's fp32 3-D convolutions (8-64
    channels, NCDHW) in slow direct kernels, above all the transposed
    convolutions and the weight gradients.  Measured, it times those
    candidates the first time it meets a convolution problem (shapes,
    strides, dtype, layout) and keeps the fastest for that
    problem for the life of the process, so every (stage, pass), plan and
    dtype policy gets its own choice.  The step factories
    (``engine/steps``) run their whole body, backward and optimizer
    included, inside this block.

    Only ``benchmark`` and ``benchmark_limit`` are set, and restored on the
    way out: TF32 (off, as ``pin_fp32`` leaves it), determinism and whether
    cuDNN is used at all stay as the caller set them.  PyTorch keeps the
    first algorithm found for a problem however it was found, so a problem
    met outside such a block first keeps the heuristic's choice.
    """
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, candidates
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved
