"""Weight bridge between the JAX package's parameter trees and the port's
state dict, in both directions.

``state_dict_from_jax(params, batch_stats)`` takes the nested numpy dicts
of a JAX ``MVSNet`` and returns a state dict in the reference's naming
(``feature.conv0.0.conv.weight``, ``cost_regularization.0.cosR_small.
conv0.bn.running_mean``, ``feature.out1.weight``,
``cost_regularization_refine.2.cosR_huge.prob.weight``, ...), which is the
port's own module layout.  Kernel layouts:

  flax Conv   (kh,kw,I,O)     -> torch (O,I,kh,kw)
  flax Conv3d (kd,kh,kw,I,O)  -> torch (O,I,kd,kh,kw)
  flax ConvTranspose with transpose_kernel stores (k..,O,I) -> torch
  ConvTranspose (I,O,k..): the same axis permutation.

``num_batches_tracked`` has no JAX counterpart and is left out; PyTorch's
batch norm fills it in on load, so the dict loads with ``strict=True``.

``jax_tree_from_state_dict(state_dict)`` is the inverse (numpy in, numpy
out): a checkpoint trained by the port becomes ``(params, batch_stats)``
for the JAX package.  Every layout change is a permutation, so applying
``state_dict_from_jax`` to a JAX *gradient* tree gives the gradients in the
port's naming.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# FeatureNet flat block names -> reference nn.Sequential positions
_FEATURE_SEQ = {
    "conv0_0": "conv0.0", "conv0_1": "conv0.1",
    "conv1_0": "conv1.0", "conv1_1": "conv1.1", "conv1_2": "conv1.2",
    "conv2_0": "conv2.0", "conv2_1": "conv2.1", "conv2_2": "conv2.2",
}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_path(path: tuple) -> str:
    """JAX module path (leaf dropped) -> reference torch module path."""
    top = path[0]
    if top == "feature":
        block = path[1]
        if block in _FEATURE_SEQ:               # ConvBlock: .conv / .bn
            return ".".join(["feature", _FEATURE_SEQ[block], *path[2:]])
        return f"feature.{block}"               # head: a raw conv
    if top.startswith("cost_reg_"):
        refine = top.startswith("cost_reg_refine_")
        stage = top.rsplit("_", 1)[1]
        name = "cost_regularization_refine" if refine else "cost_regularization"
        branch, module = path[1], path[2]
        if module == "prob":                    # a raw conv
            return f"{name}.{stage}.{branch}.prob"
        return ".".join([name, stage, branch, module, *path[3:]])
    raise KeyError(f"cannot map JAX parameter path {path!r}")


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return k.transpose(3, 2, 0, 1)
    if k.ndim == 5:
        return k.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {k.ndim}")


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX MVSNet -> the port's state dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, w in list(_flatten(params)) + list(_flatten(batch_stats)):
        leaf = path[-1]
        if leaf not in _LEAF:
            raise KeyError(f"unknown leaf in {path!r}")
        if leaf == "kernel":
            w = _kernel_to_torch(w)
        key = f"{_module_path(path[:-1])}.{_LEAF[leaf]}"
        sd[key] = torch.from_numpy(np.array(w, dtype=np.float32))
    return sd


_FEATURE_SEQ_INV = {v: k for k, v in _FEATURE_SEQ.items()}
_LEAF_INV = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def jax_tree_from_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """The port's (reference-named) state dict -> (params, batch_stats)
    nested dicts of float32 numpy arrays in the JAX package's naming.
    ``num_batches_tracked`` and ``attn_mask`` entries and a DDP ``module.``
    prefix are dropped."""
    params: dict = {}
    stats: dict = {}
    for key, value in state_dict.items():
        if "attn_mask" in key or key.endswith("num_batches_tracked"):
            continue
        w = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value,
                       dtype=np.float32)
        parts = key.split(".")
        if parts[0] == "module":
            parts = parts[1:]
        *mod, leaf = parts
        if mod[0] == "feature":
            if ".".join(mod[1:3]) in _FEATURE_SEQ_INV:     # ConvBlock: .conv / .bn
                path = ["feature", _FEATURE_SEQ_INV[".".join(mod[1:3])], *mod[3:]]
            else:                                           # head: a raw conv
                path = ["feature", mod[1], "conv"]
        elif mod[0] in ("cost_regularization", "cost_regularization_refine"):
            top = ("cost_reg_refine_" if mod[0].endswith("refine") else "cost_reg_") + mod[1]
            path = [top, *mod[2:]] + (["conv"] if mod[3] == "prob" else [])
        else:
            raise KeyError(f"unrecognized state-dict key {key!r}")
        if path[-1] == "bn":
            tree, name = (stats, _LEAF_INV[leaf]) if leaf.startswith("running_") \
                else (params, _LEAF_INV[leaf])
        elif leaf == "weight":
            # the inverse axis permutation of _kernel_to_torch
            tree, name = params, "kernel"
            w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.transpose(2, 3, 4, 1, 0)
        elif leaf == "bias":
            tree, name = params, "bias"
        else:
            raise KeyError(f"unknown leaf in {key!r}")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[name] = np.ascontiguousarray(w)
    return params, stats


def load_reference_state_dict(model: nn.Module, state_dict: dict) -> nn.Module:
    """Load a reference-named state dict into ``model``.

    Drops a DDP ``module.`` prefix and ``attn_mask`` entries as the
    reference's own loader does; every other key must match
    (``num_batches_tracked`` may be absent: batch norm fills it in).
    """
    sd = {}
    for k, v in state_dict.items():
        if "attn_mask" in k:
            continue
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        sd[k[len("module."):] if k.startswith("module.") else k] = v
    model.load_state_dict(sd, strict=True)
    return model
