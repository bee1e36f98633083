"""dmvsnet_tpu_torch — the PyTorch / CUDA port of dmvsnet_tpu for NVIDIA Hopper.

The JAX package ``dmvsnet_tpu`` is the reference: every module here mirrors
its counterpart's name and contract and is tested against it on the CPU.
This package imports neither JAX nor any module of ``dmvsnet_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without CUDA a CUDA request raises instead of carrying on
on the CPU.
"""

from __future__ import annotations

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
