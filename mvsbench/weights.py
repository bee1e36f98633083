"""Seeded weights, made on the device in one generator call and filled into
a state dict by name and shape.

The rule is the benchmark's own, so that the program's initialisation can
change without changing what a seed means:

* a convolution's weight (4 or more dimensions) and its bias:
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = weight.shape[1] * kernel;
  the cost U-Nets' probability heads (``.prob.``) ``PROB_SCALE`` times
  that.  With the plain rule the heads' four channels regress depths far
  apart, in train mode above all (batch statistics keep the logits near
  unit scale); the saddle cells extrapolate the refine hypotheses from
  their spread (3 min - 2 max, ...), and stage after stage they leave the
  scene's range (2283 mm at stage 1 and 16404 mm at stage 2 against
  425-935 mm on the card), where the plane sweep meets the camera plane and
  float32 rounding alone moves a map by 148 mm (the program's own plain
  path against the reference, PERF.md).  Small heads make the four depths
  agree, as a trained network's do, and keep every hypothesis in range;
* a batch norm's weight U(0.5, 1.5), its bias U(-0.1, 0.1), its running
  mean U(-0.1, 0.1) and running variance U(0.5, 1.5): away from the
  identity, so that the eval-time normalisation is exercised;
* ``num_batches_tracked`` 0.
"""

from __future__ import annotations

import math

import torch

PROB_SCALE = 0.01
_RANGES = {"bn.weight": (0.5, 1.5), "bn.bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
           "running_var": (0.5, 1.5)}


def _range(name: str, shapes: dict[str, torch.Size]) -> tuple[float, float]:
    for suffix, rng in _RANGES.items():
        if name.endswith(suffix):
            return rng
    weight = shapes.get(name.rsplit(".", 1)[0] + ".weight")
    if weight is None or len(weight) < 3:
        raise ValueError(f"no rule for the weight {name!r} of shape {tuple(shapes[name])}")
    bound = 1.0 / math.sqrt(weight[1] * math.prod(weight[2:]))
    if ".prob." in f".{name}":
        bound *= PROB_SCALE
    return -bound, bound


def generate(state_dict: dict[str, torch.Tensor], seed: int, device) -> dict[str, torch.Tensor]:
    """A new state dict with the names, shapes and dtypes of ``state_dict``
    and the benchmark's seeded values, on ``device``."""
    shapes = {k: v.shape for k, v in state_dict.items()}
    floats = [k for k, v in state_dict.items() if v.is_floating_point()]
    total = sum(state_dict[k].numel() for k in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, value in state_dict.items():
        if not value.is_floating_point():
            out[name] = torch.zeros_like(value, device=device)
            continue
        lo, hi = _range(name, shapes)
        n = value.numel()
        out[name] = (flat[offset:offset + n] * (hi - lo) + lo).reshape(value.shape).to(value.dtype)
        offset += n
    return out
